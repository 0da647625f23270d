"""Workload generation: the op-stream side of the bench harness.

Port of the reference's generator (`benches/hashmap.rs:131-162`): `nop`
operations over a bounded keyspace, keys drawn uniform or zipf
(`benches/hashmap.rs:29-48` uses zipf-or-uniform behind a feature flag),
write ratio in percent selecting Put vs Get. Everything is generated
up-front shaped `[S, R, B]` (steps × replicas × batch) so the measured
loop never touches the host (SURVEY.md §7 "honest throughput accounting").

The port of `node_replication_tpu/harness/workloads.py`, numpy only:
the same seed gives the same arrays, bit for bit. Batches are returned
as HOST (numpy) arrays and staged onto the device once by each runner's
`prepare`, so the measured loop performs no host-to-device copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Bench workload config (`ScaleBenchBuilder`-style knobs,
    `benches/mkbench.rs:1041-1093` + `benches/hashmap.rs:29-48`)."""

    keyspace: int = 10_000
    write_ratio: int = 50  # percent of ops that are writes
    distribution: str = "uniform"  # or "skewed" (zipf)
    zipf_theta: float = 1.03
    seed: int = 0


def zipf_keys(rng: np.random.Generator, n: int, keyspace: int,
              theta: float) -> np.ndarray:
    """Zipf-distributed keys over [0, keyspace) via rejection-free inverse
    CDF on a truncated harmonic (the 'skewed' distribution of
    `benches/hashmap.rs:143-150`)."""
    # Probability p(k) ∝ 1/(k+1)^theta over the truncated support.
    ranks = np.arange(1, keyspace + 1, dtype=np.float64)
    weights = 1.0 / np.power(ranks, theta)
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    u = rng.random(n)
    return np.searchsorted(cdf, u).astype(np.int32)


def generate_batches(
    spec: WorkloadSpec,
    n_steps: int,
    n_replicas: int,
    writes_per_replica: int,
    reads_per_replica: int,
    wr_opcode: int | tuple = 1,
    rd_opcode: int | tuple = 1,
    arg_width: int = 3,
):
    """Generate `[S, R, B]`-shaped batches for the fused step path.

    Every write slot carries (key, value) args; every read slot carries
    (key,). The write/read split is structural (separate batches) — the
    reference's per-op coin flip (`benches/hashmap.rs:152-160`) determines
    the *ratio*, which here fixes the Bw:Br shape instead, keeping shapes
    static.

    Returns `(wr_opc, wr_args, rd_opc, rd_args)` as HOST numpy arrays
    (`wr_opc int32[S, R, Bw]`, `wr_args int32[S, R, Bw, A]`, etc.) —
    runners move them to their device once, in `prepare`.
    """
    rng = np.random.default_rng(spec.seed)
    S, R, Bw, Br = n_steps, n_replicas, writes_per_replica, reads_per_replica

    def keys(n):
        if spec.distribution == "skewed":
            return zipf_keys(rng, n, spec.keyspace, spec.zipf_theta)
        return rng.integers(0, spec.keyspace, n, dtype=np.int32)

    def opcodes(choice, shape):
        # A tuple of opcodes means "pick uniformly per slot" (e.g. the
        # stack bench's 50/50 push/pop mix, `benches/stack.rs`).
        if isinstance(choice, (tuple, list)):
            return rng.choice(np.asarray(choice, np.int32), shape)
        return np.full(shape, choice, np.int32)

    wr_opc = opcodes(wr_opcode, (S, R, Bw))
    wr_args = np.zeros((S, R, Bw, arg_width), np.int32)
    wr_args[..., 0] = keys(S * R * Bw).reshape(S, R, Bw)
    wr_args[..., 1] = rng.integers(0, 1 << 31, (S, R, Bw), dtype=np.int32)
    rd_opc = opcodes(rd_opcode, (S, R, Br))
    rd_args = np.zeros((S, R, Br, arg_width), np.int32)
    rd_args[..., 0] = keys(S * R * Br).reshape(S, R, Br)
    return wr_opc, wr_args, rd_opc, rd_args


def split_write_read(total_per_replica: int, write_ratio: int) -> tuple[int, int]:
    """Fix the static (Bw, Br) shape that realizes `write_ratio` percent
    writes out of `total_per_replica` ops: at least one of each side when
    the ratio is strictly between 0 and 100 and the batch allows it
    (`total >= 2`); a single-op batch goes to whichever side the ratio
    favors."""
    if write_ratio <= 0:
        return 0, total_per_replica
    if write_ratio >= 100:
        return total_per_replica, 0
    if total_per_replica == 1:
        return (1, 0) if write_ratio >= 50 else (0, 1)
    bw = round(total_per_replica * write_ratio / 100)
    bw = min(max(bw, 1), total_per_replica - 1)
    return bw, total_per_replica - bw
