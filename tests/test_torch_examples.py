"""The port's examples against the reference's.

`examples/torch/<name>.py` is the port of `examples/<name>.py`: the same
constants, the same ops in the same order and the same asserts. Each
pair runs here in this process (`runpy`, as `python <file>` runs it),
the reference on the CPU as tier-1 runs it and the port with `--device
cpu`, and their final `<name> OK: ...` lines must be equal once timing
values and temporary paths are masked. Without `--device` a port
example asks for the card, so without one it raises
`NoCudaDeviceError` before it builds anything.
"""

import ast
import contextlib
import io
import re
import runpy
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from node_replication_torch.utils.device import NoCudaDeviceError

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("nr_hashmap", "nr_stack", "nr_elastic", "serve_hashmap",
         "cnr_hashmap", "cnr_stack", "follower_reads", "tree_replication",
         "fleet_dashboard", "sharded_hashmap")

# a timing value (`p50=2.98ms`) and a path under the temporary directory
# (`merged trace at /tmp/nr-fleet-example-x1y2/fleet.jsonl`)
_MS = re.compile(r"\d+(?:\.\d+)?ms\b")
_TMP = re.compile(re.escape(tempfile.gettempdir()) + r"/\S+")


def _masked(line: str) -> str:
    return _TMP.sub("<tmp>", _MS.sub("<t>ms", line))


@pytest.fixture
def obs_state():
    """Put back what an example leaves on the process-global registries
    and tracers of both packages (`fleet_dashboard` enables them)."""
    from node_replication_torch.obs import recorder as t_rec
    from node_replication_torch.obs.metrics import get_registry as t_reg
    from node_replication_tpu.obs import recorder as j_rec
    from node_replication_tpu.obs.metrics import get_registry as j_reg

    regs = [(r, r.enabled) for r in (t_reg(), j_reg())]
    tracers = [(m, m.get_tracer().enabled) for m in (t_rec, j_rec)]
    yield
    for reg, on in regs:
        reg.enabled = on
    for mod, on in tracers:
        if not on:
            mod.get_tracer().disable()
        mod.set_trace_sample(1)


def _run(path: Path, argv: list, monkeypatch) -> str:
    """Run `path` as `__main__` with `argv`; return its stdout."""
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(path), run_name="__main__")
    return out.getvalue()


def _ok_line(name: str, out: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith(f"{name} OK: ")]
    assert lines, f"{name} printed no OK line:\n{out[-2000:]}"
    return lines[-1]


@pytest.mark.parametrize("name", NAMES)
def test_port_example_prints_the_reference_ok_line(name, monkeypatch,
                                                   obs_state):
    ref = _ok_line(name, _run(ROOT / "examples" / f"{name}.py", [],
                              monkeypatch))
    port = _ok_line(name, _run(ROOT / "examples" / "torch" / f"{name}.py",
                               ["--device", "cpu"], monkeypatch))
    assert _masked(port) == _masked(ref)


@pytest.mark.parametrize("name", NAMES)
def test_port_example_without_a_card_raises(name, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the example would run on it")
    with pytest.raises(NoCudaDeviceError):
        _run(ROOT / "examples" / "torch" / f"{name}.py", [], monkeypatch)


def _checks(path: Path) -> int:
    """`assert` statements plus `raise AssertionError(...)` in a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return sum(
        isinstance(n, ast.Assert)
        or (isinstance(n, ast.Raise) and isinstance(n.exc, ast.Call)
            and getattr(n.exc.func, "id", "") == "AssertionError")
        for n in ast.walk(tree))


@pytest.mark.parametrize("name", NAMES)
def test_port_example_keeps_the_reference_asserts(name):
    ref = _checks(ROOT / "examples" / f"{name}.py")
    assert ref > 0
    assert _checks(ROOT / "examples" / "torch" / f"{name}.py") == ref


def test_examples_are_ported_one_for_one():
    ref = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    port = sorted(p.stem for p in (ROOT / "examples" / "torch").glob("*.py"))
    assert ref == port == sorted(NAMES)
