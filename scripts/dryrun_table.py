"""The dry-run grid as one markdown table: the port's cells beside the
reference's.

Reads the JSON files that ``python -m repro_torch.launch.dryrun --all
--both-meshes --out PORT`` and ``scripts/dryrun_reference.py --all
--both-meshes --out REF`` write (one a cell), and prints one row an
architecture x shape, each entry "pod1; pod2" (the (16, 16) and
(2, 16, 16) meshes): the port's and the reference's flops a device less
conversions and peak GB a device (of the H100's 80), the port's
bottleneck, the ops it ran replicated, and its seconds.

    python scripts/dryrun_table.py PORT REF
"""
import json
import sys
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
    port, ref = _load(Path(sys.argv[1])), _load(Path(sys.argv[2]))
    print("| arch | shape | port flops/dev | ref flops/dev | port peak GB "
          "| ref peak GB | bottleneck | replicated ops | s |")
    print("|---|---|---|---|---|---|---|---|---|")
    cells = sorted({(a, s) for a, s, _ in port} | {(a, s) for a, s, _ in ref})
    g = "{:.3g}".format
    for arch, shape in cells:
        p = [port.get((arch, shape, mp)) for mp in (False, True)]
        r = [ref.get((arch, shape, mp)) for mp in (False, True)]
        ops = sorted({o.split(".")[1] for x in p if x
                      for o in x["replicated_ops"]})
        cols = [
            _pair(g, *[_port_flops(x) if x else None for x in p]),
            _pair(g, *[_ref_flops(x) if x else None for x in r]),
            _pair(g, *[_peak_gb(x) for x in p]),
            _pair(g, *[_peak_gb(x) for x in r]),
            _pair(str, *[x["roofline"]["bottleneck"] if x else None
                         for x in p]),
            ", ".join(ops) or "—",
            _pair(str, *[x["seconds"] if x else None for x in p])]
        print(f"| {arch} | {shape} | " + " | ".join(cols) + " |")

if __name__ == "__main__":
    main()
