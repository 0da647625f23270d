"""The port stands alone and never falls back.

- No module of `node_replication_torch/`, and not `chip_smoke.py`,
  imports `jax` or `node_replication_tpu` (an AST scan of every import
  statement); `shard.__all__`, `obs.__all__` and `sim.__all__` are the
  reference's, read from its source.
- The entry points treat `device=None` as the card and raise without
  one, instead of running on the CPU.
- The kernel wrappers take their plain version only for CPU tensors:
  tensors on any other device without a usable card raise, and the
  plain version is never reached.
"""

import ast
import json
from pathlib import Path

import pytest
import torch

import node_replication_torch.ops.kernel_lib as kernel_lib
import node_replication_torch.ops.oahashmap as oahashmap
import node_replication_torch.ops.replay as replay
import node_replication_torch.ops.vspace as vspace
from node_replication_torch.core.log import LogSpec, log_init
from node_replication_torch.core.replica import NodeReplicated
from node_replication_torch.models import (
    make_hashmap,
    make_oahashmap,
    make_vspace,
    make_vspace_radix,
)
from node_replication_torch.ops.replay import (
    FUSED_KERNEL,
    REPLAY_KERNEL,
    FusedHashmapEngine,
    hashmap_fused_round_model,
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


SERVING_PATH = ("models/seqreg.py", "core/checkpoint.py", "serve/__init__.py",
                "serve/errors.py", "serve/future.py", "serve/overload.py",
                "serve/client.py", "serve/frontend.py", "fault/__init__.py",
                "fault/health.py", "fault/repair.py", "durable/__init__.py",
                "durable/wal.py", "durable/recovery.py")


def test_serving_path_modules_are_scanned_and_stand_alone():
    files = {str(f.relative_to(ROOT / "node_replication_torch"))
             for f in _port_files() if "node_replication_torch" in f.parts}
    assert set(SERVING_PATH) <= files
    for rel in SERVING_PATH:
        path = ROOT / "node_replication_torch" / rel
        assert not _imported_roots(path) & FORBIDDEN, rel


REPL_PATH = ("repl/__init__.py", "repl/feed.py", "repl/shipper.py",
             "repl/follower.py", "repl/promote.py", "repl/transport.py",
             "repl/relay.py", "obs/recorder.py", "utils/trace.py")


def test_repl_modules_are_scanned_and_stand_alone():
    files = {str(f.relative_to(ROOT / "node_replication_torch"))
             for f in _port_files() if "node_replication_torch" in f.parts}
    assert set(REPL_PATH) <= files
    for rel in REPL_PATH:
        path = ROOT / "node_replication_torch" / rel
        assert not _imported_roots(path) & FORBIDDEN, rel


SHARD_PATH = ("shard/__init__.py", "shard/ring.py", "shard/router.py",
              "shard/txn.py", "shard/primary.py", "shard/reshard.py",
              "durable/txnlog.py")


def test_shard_modules_are_scanned_and_stand_alone():
    files = {str(f.relative_to(ROOT / "node_replication_torch"))
             for f in _port_files() if "node_replication_torch" in f.parts}
    assert set(SHARD_PATH) <= files
    for rel in SHARD_PATH:
        path = ROOT / "node_replication_torch" / rel
        assert not _imported_roots(path) & FORBIDDEN, rel


def _module_all(path: Path) -> list:
    """A module's `__all__`, read from its source (importing the
    reference's package would import jax)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == ["__all__"]):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


def test_shard_exports_the_reference_names():
    import node_replication_torch.shard as shard

    ref = _module_all(ROOT / "node_replication_tpu" / "shard" / "__init__.py")
    assert len(ref) == 14
    assert shard.__all__ == ref
    assert all(hasattr(shard, n) for n in ref)


OBS_PATH = ("obs/__init__.py", "obs/metrics.py", "obs/recorder.py",
            "obs/profile.py", "obs/export.py", "obs/collect.py",
            "obs/report.py", "obs/top.py")


def test_obs_modules_are_scanned_and_stand_alone():
    files = {str(f.relative_to(ROOT / "node_replication_torch"))
             for f in _port_files() if "node_replication_torch" in f.parts}
    assert set(OBS_PATH) <= files
    for rel in OBS_PATH:
        path = ROOT / "node_replication_torch" / rel
        assert not _imported_roots(path) & FORBIDDEN, rel


def test_obs_exports_the_reference_names():
    import node_replication_torch.obs as obs

    ref = _module_all(ROOT / "node_replication_tpu" / "obs" / "__init__.py")
    assert len(ref) == 13
    assert obs.__all__ == ref
    assert all(hasattr(obs, n) for n in ref)


SIM_PATH = ("sim/__init__.py", "sim/scheduler.py", "sim/oracle.py",
            "sim/properties.py", "sim/shrink.py", "sim/replay.py",
            "sim/explore.py", "sim/canary.py", "utils/clock.py")


def test_sim_modules_are_scanned_and_stand_alone():
    files = {str(f.relative_to(ROOT / "node_replication_torch"))
             for f in _port_files() if "node_replication_torch" in f.parts}
    assert set(SIM_PATH) <= files
    for rel in SIM_PATH:
        path = ROOT / "node_replication_torch" / rel
        assert not _imported_roots(path) & FORBIDDEN, rel


def test_sim_exports_the_reference_names():
    import node_replication_torch.sim as sim

    ref = _module_all(ROOT / "node_replication_tpu" / "sim" / "__init__.py")
    assert len(ref) == 7
    assert sim.__all__ == ref
    assert all(hasattr(sim, n) for n in ref)


def test_sim_entry_points_without_a_card_raise(monkeypatch, tmp_path):
    from node_replication_torch.sim import explore, replay
    from node_replication_torch.sim.properties import generate_case, run_case

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = generate_case(2)
    artifact = tmp_path / "a.json"
    artifact.write_text(json.dumps({"spec": spec.as_dict()}))
    for entry in (
        lambda: run_case(spec),
        lambda: explore.main(["--seeds", "2", "--progress", "0"]),
        lambda: explore.main(["--seeds", "4", "--procs", "2"]),
        lambda: explore.main(["--canary", "ack-before-fsync",
                              "--seeds", "2"]),
        lambda: replay.main(["2"]),
        lambda: replay.main(["--spec", str(artifact), "--json"]),
    ):
        with pytest.raises(NoCudaDeviceError):
            entry()
    # the caller asking for the CPU is the only way onto it
    assert run_case(spec, device="cpu").ok
    assert replay.main(["2", "--device", "cpu"]) == 0
    assert explore.main(["--seeds", "2", "--progress", "0",
                         "--device", "cpu"]) == 0


def test_shard_group_without_a_card_raises(monkeypatch, tmp_path):
    from node_replication_torch.shard import ShardGroup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        ShardGroup(2, make_hashmap(8), str(tmp_path / "g"))
    with pytest.raises(NoCudaDeviceError):
        ShardGroup(2, make_hashmap(8), str(tmp_path / "h"),
                   nr_kwargs=dict(n_replicas=1, log_entries=256,
                                  gc_slack=32))


def test_follower_without_a_card_raises(monkeypatch, tmp_path):
    from node_replication_torch.models import make_seqreg
    from node_replication_torch.repl import DirectoryFeed, Follower

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feed = DirectoryFeed(str(tmp_path / "feed"))
    with pytest.raises(NoCudaDeviceError):
        Follower(make_seqreg(4), feed, str(tmp_path / "f"),
                 auto_start=False)


def test_serving_entry_points_without_a_card_raise(monkeypatch, tmp_path):
    from node_replication_torch.durable import recover_fleet
    from node_replication_torch.models import make_seqreg
    from node_replication_torch.serve import ServeFrontend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (
        lambda: make_seqreg(4).make_state(),
        lambda: NodeReplicated(make_seqreg(4), 2),
        lambda: recover_fleet(str(tmp_path / "a"), make_hashmap(8)),
        lambda: ServeFrontend.from_recovery(str(tmp_path / "b"),
                                            make_seqreg(4)),
    ):
        with pytest.raises(NoCudaDeviceError):
            entry()
    # a snapshot restores onto the card unless the caller asks for the CPU
    nr = NodeReplicated(make_seqreg(4), 2, log_entries=256, gc_slack=64,
                        device="cpu")
    nr.execute_mut_batch([(1, 1, 5)], rid=0)
    nr.checkpoint(str(tmp_path / "s.npz"))
    with pytest.raises(NoCudaDeviceError):
        NodeReplicated.restore(str(tmp_path / "s.npz"), make_seqreg(4))
    back = NodeReplicated.restore(str(tmp_path / "s.npz"), make_seqreg(4),
                                  device="cpu")
    assert int(back.log.tail) == 1


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
    spec = LogSpec(n_replicas=2, capacity=512, gc_slack=64)
    for entry in (
        lambda: NodeReplicated(make_vspace(512, 8), 2),
        lambda: NodeReplicated(make_vspace(512, 8), 2, engine="pallas",
                               log_entries=512, gc_slack=64),
        lambda: make_vspace(512, 8).make_state(),
        lambda: make_vspace(512, 8).fused_factory(spec),
        lambda: vspace.pallas_vspace_state(512, 2, False),
        lambda: vspace.FusedVspaceEngine(512, 8, spec),
        lambda: NodeReplicated(make_vspace_radix(1500, 8), 2),
        lambda: make_vspace_radix(1500, 8).make_state(),
        lambda: vspace.pallas_vspace_state(1500, 2, True),
        lambda: NodeReplicated(make_oahashmap(300, 8), 2),
        lambda: make_oahashmap(300, 8).make_state(),
        lambda: oahashmap.pallas_oahashmap_state(300, 2),
    ):
        with pytest.raises(NoCudaDeviceError):
            entry()
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
    for name in ("vspace_replay_plain", "vspace_plan_replay_plain",
                 "vspace_fused_round_plain", "_replay_plain",
                 "vspace_radix_replay_plain",
                 "vspace_radix_plan_replay_plain", "_radix_plain"):
        monkeypatch.setattr(vspace, name, boom)
    monkeypatch.setattr(oahashmap, "oahashmap_replay_plain", boom)


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
    opc = torch.zeros(3, dtype=torch.int32, device="meta")
    args = torch.zeros((3, 3), dtype=torch.int32, device="meta")
    v = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    p = torch.zeros((4, 8), dtype=torch.bool, device="meta")
    before = FUSED_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA device"):
        hashmap_fused_round_model(spec, log.tail, 2, opc, args, log.opcodes,
                                  log.args, v, p, 8)
    assert FUSED_KERNEL.launches == before


def _vs_window(device, W=3, R=2, P=512):
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    return z(W), z(W, 3), z(R, P)


def test_vspace_wrappers_refuse_non_cpu_tensors(no_plain):
    counts = lambda: [k.launches for k in (
        vspace.REPLAY_KERNEL, vspace.PLAN_KERNEL, vspace.FUSED_KERNEL)]
    before = counts()
    opc, args, fr = _vs_window("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        vspace.vspace_replay(opc, args, fr, 512, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        vspace.vspace_plan_replay(opc, args, fr[:1], fr[:1], 512, 8)
    spec = LogSpec(n_replicas=2, capacity=512, gc_slack=64)
    log = log_init(spec, "meta")
    with pytest.raises(ValueError, match="CUDA device"):
        vspace.vspace_fused_round(spec, log.tail, 2, opc, args,
                                  log.opcodes, log.args, fr, 512, 8)
    # one tensor off the CPU is enough to refuse the mix
    opc, args, fr = _vs_window("cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        vspace.vspace_replay(opc, args.to("meta"), fr, 512, 8)
    assert counts() == before


def test_vspace_steps_route_non_cpu_tensors_to_the_kernels(no_plain):
    # both step paths hand tensors that are not on the CPU to a kernel
    # wrapper, which refuses them here: the plain version is not reached
    P, R, S = 512, 2, 8
    spec = LogSpec(n_replicas=R, capacity=512, gc_slack=64)
    meta = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")
    batch = (meta(R, 1), meta(R, 1, 3), meta(R, 1), meta(R, 1, 3))
    steps = (
        (vspace.make_pallas_vspace_step(P, spec, 1, 1, S, radix=False),
         {"frames": meta(R, vspace.grid_rows(P), 128)}),
        (vspace.make_pallas_vspace_plan_step(P, spec, 1, 1, S, radix=False,
                                             dispatch=make_vspace(P, S)),
         {"frames": meta(R, P)}),
    )
    for step, states in steps:
        with pytest.raises(ValueError, match="CUDA device"):
            step(log_init(spec, "meta"), states, *batch)


def _radix_state(device, R=2, P=1500):
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    return {"pt": z(R, vspace.grid_rows(P), 128), "pd": z(3), "pdpt": z(1),
            "pml4": z(1)}


def test_radix_and_oahashmap_wrappers_refuse_non_cpu_tensors(no_plain):
    counts = lambda: [k.launches for k in (*vspace.KERNELS,
                                           oahashmap.REPLAY_KERNEL)]
    before = counts()
    P, S = 1500, 8
    opc, args, _ = _vs_window("meta")
    st = _radix_state("meta")
    lv = (st["pd"], st["pdpt"], st["pml4"])
    with pytest.raises(ValueError, match="CUDA device"):
        vspace.vspace_radix_replay(opc, args, st["pt"], *lv, P, S)
    pt1 = st["pt"][:1]
    with pytest.raises(ValueError, match="CUDA device"):
        vspace.vspace_radix_plan_replay(opc, args, pt1, *lv, pt1, pt1,
                                        st["pd"], P, S)
    planes = oahashmap.pallas_oahashmap_state(300, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        oahashmap.oahashmap_replay(opc, args, *planes.values(), 300, 8)
    # one tensor off the CPU is enough to refuse the mix
    cpu = _radix_state("cpu")
    opc, args, _ = _vs_window("cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        vspace.vspace_radix_replay(opc, args, cpu["pt"], cpu["pd"],
                                   cpu["pdpt"], cpu["pml4"].to("meta"), P, S)
    assert counts() == before


def test_radix_and_oahashmap_steps_route_non_cpu_tensors_to_the_kernels(
        no_plain):
    R = 2
    spec = LogSpec(n_replicas=R, capacity=512, gc_slack=64)
    meta = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")
    batch = (meta(R, 1), meta(R, 1, 3), meta(R, 1), meta(R, 1, 3))
    radix = make_vspace_radix(1500, 8)
    model = {"pt": meta(R, 1500), "pd": meta(R, 3).bool(),
             "pdpt": meta(R, 1).bool(), "pml4": meta(R, 1).bool()}
    steps = (
        (vspace.make_pallas_vspace_step(1500, spec, 1, 1, 8, radix=True),
         _radix_state("meta")),
        (vspace.make_pallas_vspace_plan_step(1500, spec, 1, 1, 8,
                                             radix=True, dispatch=radix),
         model),
        (oahashmap.make_pallas_oahashmap_step(300, 8, spec, 1, 1),
         oahashmap.pallas_oahashmap_state(300, R, device="meta")),
    )
    for step, states in steps:
        with pytest.raises(ValueError, match="CUDA device"):
            step(log_init(spec, "meta"), states, *batch)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    # no toolkit: the build raises rather than handing back anything
    monkeypatch.setattr(kernel_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernel_lib, "_libs", {})
    monkeypatch.setattr(kernel_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernel_lib.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_lib.build_all()
    # every kernel source is built, each into its own library
    assert {p.name for p in kernel_lib.sources()} == {
        "hashmap_replay.cu", "oahashmap_replay.cu", "vspace_radix_replay.cu",
        "vspace_replay.cu"}


CNR_PATH = ("core/multilog.py", "core/cnr.py", "ops/windowkit.py",
            "models/partitioned.py", "models/stack.py", "models/queue.py",
            "models/sortedset.py", "models/memfs.py", "models/synthetic.py")


def test_cnr_modules_are_scanned_and_stand_alone():
    for rel in CNR_PATH:
        path = ROOT / "node_replication_torch" / rel
        assert path.exists(), rel
        assert not _imported_roots(path) & FORBIDDEN, rel


def test_cnr_entry_points_without_a_card_raise(monkeypatch):
    import node_replication_torch as nrt
    from node_replication_torch.core.multilog import (
        MultiLogSpec,
        multilog_init,
        partition_ops,
    )
    from node_replication_torch.models import (
        make_memfs,
        make_partitioned_hashmap,
        make_queue,
        make_sortedset,
        make_stack,
        make_synthetic,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mapper = lambda opc, args: args[0]  # noqa: E731
    spec = MultiLogSpec(nlogs=2, capacity=64, n_replicas=2, gc_slack=8)
    for entry in (
        lambda: nrt.MultiLogReplicated(make_hashmap(8), mapper, 2, 2),
        lambda: nrt.MultiLogReplicated(make_hashmap(8), mapper, 2, 2,
                                       engine="pallas"),
        lambda: multilog_init(spec),
        lambda: partition_ops(mapper, 2, [(1, (0, 1))], 3),
        lambda: make_partitioned_hashmap(8, 2).full.make_state(),
        lambda: make_stack(4).make_state(),
        lambda: make_queue(4).make_state(),
        lambda: make_sortedset(4).make_state(),
        lambda: make_memfs(4, 2).make_state(),
        lambda: make_synthetic(16).make_state(),
    ):
        with pytest.raises(NoCudaDeviceError):
            entry()
    c = nrt.MultiLogReplicated(make_hashmap(8), mapper, 2, 2,
                               device="cpu")
    assert c.execute_mut((1, 3, 7), c.register(0)) == 0
    assert c.execute((1, 3), c.register(1)) == 7


PARALLEL_PATH = ("parallel/__init__.py", "parallel/topology.py",
                 "parallel/mesh.py", "parallel/collectives.py")


def test_parallel_modules_are_scanned_and_stand_alone():
    for rel in PARALLEL_PATH:
        path = ROOT / "node_replication_torch" / rel
        assert path.exists(), rel
        assert not _imported_roots(path) & FORBIDDEN, rel
    import node_replication_torch.parallel as par

    assert len(par.__all__) == 10


def test_mesh_entry_points_without_a_card_raise(monkeypatch):
    import node_replication_torch as nrt
    from node_replication_torch.parallel import (
        MachineTopology,
        ReplicaStrategy,
        make_mesh,
        replica_mesh,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mapper = lambda opc, args: args[0]  # noqa: E731
    for entry in (
        lambda: MachineTopology(),
        lambda: make_mesh(),
        lambda: replica_mesh(2),
        lambda: NodeReplicated(make_hashmap(8), 2, mesh=2),
        lambda: NodeReplicated(make_hashmap(8), 2,
                               mesh=ReplicaStrategy.PER_DEVICE),
    ):
        with pytest.raises(NoCudaDeviceError):
            entry()
    # an explicit CPU mesh is the caller asking for the CPU
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    c = nrt.MultiLogReplicated(make_hashmap(8), mapper, 2, 2, mesh=mesh)
    assert c.device == torch.device("cpu")
    assert c.execute_mut((1, 3, 7), c.register(0)) == 0
    assert c.execute((1, 3), c.register(1)) == 7


HARNESS_PATH = ("harness/__init__.py", "harness/trait.py",
                "harness/workloads.py", "harness/mkbench.py",
                "native/__init__.py", "native/engine.py")


def test_harness_and_native_modules_are_scanned_and_stand_alone():
    files = {str(f.relative_to(ROOT / "node_replication_torch"))
             for f in _port_files() if "node_replication_torch" in f.parts}
    assert set(HARNESS_PATH) <= files
    for rel in HARNESS_PATH:
        path = ROOT / "node_replication_torch" / rel
        assert not _imported_roots(path) & FORBIDDEN, rel


@pytest.mark.parametrize("pkg,n", [("harness", 12), ("native", 8)])
def test_harness_and_native_export_the_reference_names(pkg, n):
    import importlib

    mod = importlib.import_module(f"node_replication_torch.{pkg}")
    ref = _module_all(ROOT / "node_replication_tpu" / pkg / "__init__.py")
    assert len(ref) == n
    assert mod.__all__ == ref
    assert all(hasattr(mod, name) for name in ref)


def test_harness_entry_points_without_a_card_raise(monkeypatch, tmp_path):
    from node_replication_torch.harness import (
        ConcurrentDsRunner,
        MultiLogRunner,
        PartitionedRunner,
        ReplicatedRunner,
        ScaleBenchBuilder,
        ShardedRunner,
        WorkloadSpec,
        baseline_comparison,
    )
    from node_replication_torch.harness.mkbench import (
        measure_kernel,
        measure_mesh,
    )
    from node_replication_torch.harness.trait import ShardedCnrRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hm = lambda: make_hashmap(16)  # noqa: E731
    sweep = lambda **kw: (ScaleBenchBuilder(  # noqa: E731
        hm, "x", WorkloadSpec(keyspace=16), **kw).replicas([2])
        .batches([2]).duration(0.01).out_dir(str(tmp_path)))
    for entry in (
        lambda: ReplicatedRunner(hm(), 2, 1, 1),
        lambda: MultiLogRunner(hm(), 2, 2, 1, 1),
        lambda: PartitionedRunner(hm(), 2, 1, 1),
        lambda: ConcurrentDsRunner(hm(), 2, 1, 1),
        lambda: ShardedRunner(hm(), 2, 1, 1),
        lambda: ShardedRunner(hm(), 2, 1, 1, n_devices=2),
        lambda: ShardedCnrRunner(hm(), 2, 2, 1, 1),
        lambda: sweep().run(),
        lambda: sweep(device="cpu").systems(["sharded"]).run(),
        lambda: baseline_comparison(hm, "x", WorkloadSpec(keyspace=16),
                                    batch_sizes=[2], duration_s=0.01,
                                    out_dir=str(tmp_path)),
        lambda: measure_kernel(16, 2, 4, duration_s=0.01),
        lambda: measure_kernel(16, 4, 4, duration_s=0.01, devices=2),
        lambda: measure_mesh(hm, [1, 2], 2, duration_s=0.01),
    ):
        with pytest.raises(NoCudaDeviceError):
            entry()
    # the caller naming the CPU is the only way onto it
    runner = ShardedRunner(hm(), 4, 1, 1, n_devices=["cpu"] * 2)
    assert runner.mesh.devices.size == 2
    res = sweep(device="cpu", devices=["cpu"] * 2).systems(
        ["nr", "sharded"]).run()
    assert [r.name for r in res] == ["nr", "nr-mesh2"]


ANALYSIS_PATH = ("analysis/__init__.py", "analysis/astutil.py",
                 "analysis/rules.py", "analysis/concurrency.py",
                 "analysis/lint.py", "analysis/locks.py")


def test_analysis_modules_are_scanned_and_stand_alone():
    # analysis/ is stdlib only: not even torch (it lints, and its lock
    # factory is imported by every subsystem at import time)
    files = {str(f.relative_to(ROOT / "node_replication_torch"))
             for f in _port_files() if "node_replication_torch" in f.parts}
    assert set(ANALYSIS_PATH) <= files
    for rel in ANALYSIS_PATH:
        path = ROOT / "node_replication_torch" / rel
        roots = _imported_roots(path)
        assert not roots & (FORBIDDEN | {"torch", "numpy"}), rel


@pytest.mark.parametrize("mod", ["analysis", "analysis.locks"])
def test_analysis_exports_the_reference_names(mod):
    import importlib

    ours = importlib.import_module(f"node_replication_torch.{mod}")
    path = ROOT / "node_replication_tpu" / (
        mod.replace(".", "/") + ("/__init__.py" if mod == "analysis"
                                 else ".py"))
    ref = _module_all(path)
    assert set(ref) <= set(ours.__all__)
    assert all(hasattr(ours, n) for n in ref)


# the port's user-facing scripts: one example for each of the
# reference's `examples/*.py`, and the TSAN stress of its native engine
PORT_SCRIPTS = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "examples" / "torch").glob("*.py")
) + ["scripts/tsan_stress_torch.py"]


def test_port_scripts_are_all_listed():
    assert len(PORT_SCRIPTS) == 11
    assert all((ROOT / rel).exists() for rel in PORT_SCRIPTS)


@pytest.mark.parametrize("rel", PORT_SCRIPTS)
def test_port_script_imports_neither_jax_nor_the_reference(rel):
    roots = _imported_roots(ROOT / rel)
    assert "node_replication_torch" in roots
    assert not roots & FORBIDDEN
