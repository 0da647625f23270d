"""The port stands alone and never falls back.

- No module of `node_replication_torch/`, and not `chip_smoke.py`,
  imports `jax` or `node_replication_tpu` (an AST scan of every import
  statement).
- The entry points treat `device=None` as the card and raise without
  one, instead of running on the CPU.
- The kernel wrappers take their plain version only for CPU tensors:
  tensors on any other device without a usable card raise, and the
  plain version is never reached.
"""

import ast
from pathlib import Path

import pytest
import torch

import node_replication_torch.ops.replay as replay
from node_replication_torch.core.log import LogSpec, log_init
from node_replication_torch.core.replica import NodeReplicated
from node_replication_torch.models import make_hashmap
from node_replication_torch.ops.replay import (
    FUSED_KERNEL,
    REPLAY_KERNEL,
    FusedHashmapEngine,
    hashmap_fused_round,
    hashmap_replay,
    pallas_hashmap_state,
)
from node_replication_torch.utils.device import NoCudaDeviceError

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "node_replication_tpu"}


def _port_files():
    files = sorted((ROOT / "node_replication_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & FORBIDDEN)
           for f in files}
    assert not {f: b for f, b in bad.items() if b}


def test_scan_catches_a_forbidden_import(tmp_path):
    # the scanner itself: every spelling of a jax import is caught
    src = tmp_path / "m.py"
    src.write_text("import os\nimport jax.numpy as jnp\n"
                   "from node_replication_tpu.ops import encoding\n"
                   "def f():\n    import importlib\n"
                   "    return importlib.import_module('jaxlib')\n")
    assert _imported_roots(src) & FORBIDDEN == FORBIDDEN


def test_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        NodeReplicated(make_hashmap(8), 2)
    with pytest.raises(NoCudaDeviceError):
        log_init(LogSpec(n_replicas=2, capacity=256, gc_slack=64))
    with pytest.raises(NoCudaDeviceError):
        make_hashmap(8).make_state()
    with pytest.raises(NoCudaDeviceError):
        pallas_hashmap_state(8, 2)
    with pytest.raises(NoCudaDeviceError):
        FusedHashmapEngine(8, LogSpec(n_replicas=2, capacity=256,
                                      gc_slack=64))
    # the caller asking for the CPU is the only way onto it
    nr = NodeReplicated(make_hashmap(8), 2, log_entries=256, gc_slack=64,
                        device="cpu")
    assert nr.execute_mut((1, 3, 7), nr.register(0)) == 0
    assert nr.execute((1, 3), nr.register(1)) == 7


def _planes(device, R=4, kp=8, W=3):
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    return z(W), z(W), z(W), z(kp, R), z(kp, R)


@pytest.fixture
def no_plain(monkeypatch):
    """Any reach for a plain version fails the test."""
    def boom(*a, **k):
        raise AssertionError("plain version reached for non-CPU tensors")

    monkeypatch.setattr(replay, "hashmap_replay_plain", boom)
    monkeypatch.setattr(replay, "hashmap_fused_round_plain", boom)


def test_replay_wrapper_refuses_non_cpu_tensors(no_plain):
    before = REPLAY_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA device"):
        hashmap_replay(*_planes("meta"), n_keys=8)
    # one tensor off the CPU is enough to refuse the mix
    opc, key, val, v, p = _planes("cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        hashmap_replay(opc, key, val, v.to("meta"), p, n_keys=8)
    assert REPLAY_KERNEL.launches == before


def test_fused_wrapper_refuses_non_cpu_tensors(no_plain):
    spec = LogSpec(n_replicas=4, capacity=256, gc_slack=64)
    log = log_init(spec, "meta")
    opc, _, _, v, p = _planes("meta")
    args = torch.zeros((3, 3), dtype=torch.int32, device="meta")
    before = FUSED_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA device"):
        hashmap_fused_round(spec, log.tail, 2, opc, args, log.opcodes,
                            log.args, v, p, 8)
    assert FUSED_KERNEL.launches == before


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    # no toolkit: the build raises rather than handing back anything
    monkeypatch.setattr(replay, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(replay, "_lib", None)
    monkeypatch.setattr(replay.shutil, "which", lambda name: None)
    monkeypatch.setattr(replay.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        replay.build_library()
