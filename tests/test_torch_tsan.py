"""The port's native engine under ThreadSanitizer.

`scripts/tsan_stress_torch.py` builds `node_replication_torch/native/
nr_native.cpp` with `-fsanitize=thread` and stresses NR flat combining,
CNR cross-log batches, CNR with relaxed multikey reads, and the
lockfree and evmap comparison maps. The gate has two halves: exit 0
(TSAN turns a report into exit code 66 only at process exit) and no
`WARNING: ThreadSanitizer` line on stderr.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _libtsan() -> str | None:
    try:
        out = subprocess.run(["g++", "-print-file-name=libtsan.so"],
                             capture_output=True, text=True).stdout.strip()
    except FileNotFoundError:
        return None
    # g++ echoes the bare name back when it has no such library
    return out if os.path.isabs(out) and os.path.exists(out) else None


def test_native_engine_has_no_tsan_reports():
    if _libtsan() is None:
        pytest.skip("g++ has no libtsan.so: the sanitized build cannot run")
    env = dict(os.environ, NR_TPU_TSAN="1")
    env.pop("LD_PRELOAD", None)
    p = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "tsan_stress_torch.py"),
         "0.5"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    warnings = p.stderr.count("WARNING: ThreadSanitizer")
    assert p.returncode == 0 and warnings == 0, (
        p.returncode, warnings, p.stderr[-4000:])
    assert "tsan stress OK" in p.stdout
    assert (ROOT / "node_replication_torch" / "native" / "build"
            / "libnr_native_tsan.so").exists()
