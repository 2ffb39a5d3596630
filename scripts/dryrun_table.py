"""The dry-run grid as one markdown table: the port's cells beside the
reference's.

Reads the JSON files that ``python -m repro_torch.launch.dryrun --all
--both-meshes --out PORT`` and ``scripts/dryrun_reference.py --all
--both-meshes --out REF`` write (one a cell), and prints one row an
architecture x shape, each entry "pod1; pod2" (the (16, 16) and
(2, 16, 16) meshes): the port's flops a device less conversions over
the reference's (with ``--before DIR``, an earlier port grid's ratio
first, "before -> after"), both counts, the port's and the reference's
peak GB a device (of the H100's 80; with ``--before``, the earlier
port's first), the port's bottleneck and the ops it ran replicated.
A last line gives the ratios' range and the largest peak.

    python scripts/dryrun_table.py PORT REF [--before DIR]
"""
import argparse
import json
from pathlib import Path


def _load(d: Path):
    out = {}
    for f in sorted(d.glob("*.json")):
        r = json.loads(f.read_text())
        out[(r["arch"], r["shape"], bool(r["multi_pod"]))] = r
    return out


def _port_flops(r) -> float:
    return r["flops_per_device"] - r["flops_by_dtype"].get("convert", 0)


def _ref_flops(r) -> float:
    return r["flops_per_device"] - r["convert_elements"]["adjusted"]


def _peak_gb(r):
    return r["memory"]["peak_bytes"] / 1e9 if r else None


def _pair(fmt, a, b) -> str:
    return "; ".join(fmt(x) if x is not None else "failed" for x in (a, b))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("port")
    ap.add_argument("ref")
    ap.add_argument("--before", default=None)
    args = ap.parse_args()
    port, ref = _load(Path(args.port)), _load(Path(args.ref))
    before = _load(Path(args.before)) if args.before else None
    print("| arch | shape | port/ref flops | port flops/dev | ref flops/dev "
          "| port peak GB | ref peak GB | bottleneck | replicated ops |")
    print("|---|---|---|---|---|---|---|---|---|")
    cells = sorted({(a, s) for a, s, _ in port} | {(a, s) for a, s, _ in ref})
    g = "{:.3g}".format
    ratios, peaks = [], []

    def ratio(p, r):
        if not (p and r):
            return None
        return _port_flops(p) / _ref_flops(r)
    for arch, shape in cells:
        keys = [(arch, shape, mp) for mp in (False, True)]
        p, r = [port.get(k) for k in keys], [ref.get(k) for k in keys]
        now = [ratio(a, b) for a, b in zip(p, r)]
        ratios += [x for x in now if x is not None]
        peaks += [_peak_gb(x) for x in p if x]
        rat, peak = _pair(g, *now), _pair(g, *[_peak_gb(x) for x in p])
        if before is not None:
            b = [before.get(k) for k in keys]
            rat = _pair(g, *[ratio(a, c) for a, c in zip(b, r)]) + \
                " -> **" + rat + "**"
            peak = _pair(g, *[_peak_gb(x) for x in b]) + " -> " + peak
        ops = sorted({o.split(".")[1] for x in p if x
                      for o in x["replicated_ops"]})
        cols = [
            rat,
            _pair(g, *[_port_flops(x) if x else None for x in p]),
            _pair(g, *[_ref_flops(x) if x else None for x in r]),
            peak,
            _pair(g, *[_peak_gb(x) for x in r]),
            _pair(str, *[x["roofline"]["bottleneck"] if x else None
                         for x in p]),
            ", ".join(ops) or "—"]
        print(f"| {arch} | {shape} | " + " | ".join(cols) + " |")
    if ratios:
        print(f"\nport/ref flops {min(ratios):.3g} to {max(ratios):.3g} "
              f"over {len(ratios)} cells; largest port peak "
              f"{max(peaks):.3g} GB")


if __name__ == "__main__":
    main()
