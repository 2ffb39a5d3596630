"""The port's configs and public names against the JAX package's.

The paper's three EraRAG profiles are held equal field for field to the
reference's.  The name guard reads both packages' sources with ``ast``
(it imports neither) and fails on any public name of ``src/repro/`` —
a top-level function, class or constant, or a public method of a public
class — that its port module does not carry and ``GAPS`` does not list
with its reason.
"""
import ast
from pathlib import Path

import pytest

import repro.configs.erarag as ref_erarag
import repro_torch.configs.erarag as port_erarag

SRC = Path(__file__).resolve().parent.parent / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

KERNELS = ("flash_attention", "hamming_topk", "lsh_hash", "mips_topk")

# reference module -> its port counterpart, where the path differs
MODULES = {
    # the port counts one rank's ops of a DTensor step on fake tensors,
    # not the collectives of compiled HLO text
    "distributed/hlo_analysis.py": "distributed/comm_analysis.py",
    # the Pallas kernels: hand-written CUDA C++, loaded through ctypes
    **{f"kernels/{k}/kernel.py": f"csrc/{k}.cu" for k in KERNELS},
}

# "module:name" (or "module:Class.method") -> (kind, detail): every
# public name of the reference that its port module does not carry.
# kind "renamed" gives the port's name, which must exist there.
GAPS = {
    **{f"kernels/{k}/kernel.py:{k}_pallas":
       ("tpu_only", f"the Pallas kernel; its counterpart is "
                    f"src/repro_torch/csrc/{k}.cu") for k in KERNELS},
    "kernels/common.py:on_tpu": ("tpu_only", "a TPU backend probe"),
    "kernels/common.py:interpret_default":
        ("tpu_only", "Pallas interpret mode off the TPU; a CUDA wrapper "
                     "runs its plain version only on CPU tensors"),
    "kernels/common.py:tpu_compiler_params":
        ("tpu_only", "Mosaic compiler parameters"),
    # Pallas tiling and packing helpers that no reference module calls;
    # the CUDA grids are mips_scan_grid, rescore_grid and lsh_grid, and
    # the CUDA kernels pack sign bits with shifts
    "kernels/common.py:pick_block": ("tpu_only", "a Pallas block size"),
    "kernels/common.py:round_up": ("tpu_only", "pads a Pallas block"),
    "kernels/common.py:POW2_32": ("tpu_only", "bit-packing weights"),
    "kernels/common.py:shard_map_collective":
        ("tpu_only", "a jax shard_map wrapper; the port's collective "
                     "runs over a torch.distributed group "
                     "(launch/mesh.py)"),
    "launch/mesh.py:local_data_mesh": ("renamed", "local_data_group"),
    "distributed/hlo_analysis.py:ICI_BW": ("renamed", "NVLINK_BW"),
    "common/utils.py:timed":
        ("divergence", "ROADMAP.md recorded divergence 5: the port "
                       "re-exports timed_block, which timed only calls"),
    "models/transformer.py:Params": ("type_alias", "Dict[str, Any]"),
    "models/recsys.py:Params": ("type_alias", "Dict[str, Any]"),
    "models/gnn.py:Params": ("type_alias", "Dict[str, Any]"),
}
KINDS = {"tpu_only", "renamed", "divergence", "type_alias"}


@pytest.mark.parametrize("name", [
    "ERARAG_DEFAULT", "ERARAG_QUANTIZED", "ERARAG_STREAMING"])
def test_profile_equals_reference(name):
    assert getattr(port_erarag, name).__dict__ == \
        getattr(ref_erarag, name).__dict__


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _defined(tree: ast.Module):
    """``({public top-level name}, {public class: {public method}})``
    of a module's own definitions."""
    names, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            classes[node.name] = {
                n.name for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not n.name.startswith("_")}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(el, ast.Name):
                        names.add(el.id)
    return ({n for n in names if not n.startswith("_")},
            {c: m for c, m in classes.items() if not c.startswith("_")})


def _port_names(path: Path):
    """The names a port module carries (defined or imported) and the
    public methods of each class it defines."""
    tree = _tree(path)
    names, classes = _defined(tree)
    imported = {alias.asname or alias.name.split(".")[0]
                for node in tree.body
                if isinstance(node, (ast.Import, ast.ImportFrom))
                for alias in node.names}
    return names | imported, classes


def _missing():
    """Every public name of the reference its port module lacks:
    ``{"module:name" or "module:Class.method"}``."""
    missing = set()
    for ref in sorted(REF.rglob("*.py")):
        rel = ref.relative_to(REF).as_posix()
        names, classes = _defined(_tree(ref))
        port = PORT / MODULES.get(rel, rel)
        assert port.is_file(), f"{rel}: no port module {port}"
        if port.suffix != ".py":
            missing |= {f"{rel}:{n}" for n in names}
            continue
        have, have_classes = _port_names(port)
        missing |= {f"{rel}:{n}" for n in names - have}
        for cls, methods in classes.items():
            missing |= {f"{rel}:{cls}.{m}"
                        for m in methods - have_classes.get(cls, set())}
    return missing


def test_every_public_name_has_its_counterpart():
    missing = _missing()
    unlisted = sorted(missing - set(GAPS))
    assert not unlisted, (
        f"public names of the JAX package with no port counterpart and "
        f"no entry in GAPS: {unlisted}")
    # every entry is still a gap, has a known reason, and a renamed one
    # names what the port carries instead
    assert sorted(set(GAPS) - missing) == []
    for key, (kind, detail) in GAPS.items():
        assert kind in KINDS and detail, key
        if kind == "renamed":
            rel = key.split(":")[0]
            have, _ = _port_names(PORT / MODULES.get(rel, rel))
            assert detail in have, (key, detail)
