"""nrlint over the port (`node_replication_torch/analysis/`): one firing
and one clean fixture per rule, the suppression / severity /
device-path machinery, and differentials against the reference
package's engine.

The twin of tests/test_analysis.py. Fixtures are self-contained snippet
files written to tmp_path; the analyzer is purely syntactic, so the
snippets never import anything at test time — `import torch` lines
exist only for the analyzer's name resolution. The nine rules that the
reference seeds from JAX tracing read torch here, on the device path
(`Dispatch` transitions, step and round closures, kernel wrappers), so
their fixtures are written in torch; the other rules keep the
reference's fixtures, and `TestDifferential` runs those fixtures
through both engines.
"""

import os
import textwrap

import pytest

from node_replication_torch.analysis.lint import main, run_lint
from node_replication_torch.analysis.rules import RULES


def lint_src(tmp_path, source, name="snippet.py", select=None):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    diags, errors = run_lint([str(p)], select=select)
    assert not errors, errors
    return diags


def lint_in(tmp_path, subdir, source, name="snippet.py"):
    d = tmp_path / subdir
    d.mkdir(parents=True, exist_ok=True)
    p = d / name
    p.write_text(textwrap.dedent(source))
    diags, errors = run_lint([str(p)])
    assert not errors, errors
    return diags


def firing(diags, rule_id):
    return [d for d in diags if d.rule_id == rule_id and not d.suppressed]


def write_pkg(tmp_path, files: dict):
    """A fake `node_replication_torch` package under tmp_path (module
    paths -> sources), so the device-path seeds that name project
    modules (`core.step.make_step`, the kernel wrapper modules) resolve
    in a fixture. Returns the package directory."""
    root = tmp_path / "node_replication_torch"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    for d in [root, *[p for p in root.rglob("*") if p.is_dir()]]:
        init = d / "__init__.py"
        if not init.exists():
            init.write_text("")
    return root


def lint_pkg(tmp_path, files: dict):
    root = write_pkg(tmp_path, files)
    diags, errors = run_lint([str(root)])
    assert not errors, errors
    return diags


# indented as a fixture inside a test method (12 spaces), so that
# `DISPATCH_HEAD + """..."""` dedents as one block
DISPATCH_HEAD = """
            import numpy as np
            import torch
            from node_replication_torch.ops.encoding import Dispatch
"""


class TestHostSyncInJit:
    def test_item_in_window_plan_fires(self, tmp_path):
        # the acceptance fixture: `.item()` in a Dispatch window_plan
        diags = lint_src(tmp_path, DISPATCH_HEAD + """
            def plan(state, opcodes, args):
                n = opcodes.sum().item()
                return {"n": n}

            D = Dispatch(name="m", make_state=dict, write_ops=(),
                         read_ops=(), window_plan=plan)
        """)
        hits = firing(diags, "host-sync-in-jit")
        assert len(hits) == 1 and ".item()" in hits[0].message

    def test_np_asarray_of_tensor_in_transition_fires(self, tmp_path):
        diags = lint_src(tmp_path, DISPATCH_HEAD + """
            def get(states, args):
                return torch.as_tensor(np.asarray(states["v"]))

            D = Dispatch(name="m", make_state=dict, write_ops=(),
                         read_ops=(get,))
        """)
        assert len(firing(diags, "host-sync-in-jit")) == 1

    def test_cpu_via_call_graph_fires(self, tmp_path):
        # helper is on the device path only transitively (called from
        # a registered transition)
        diags = lint_src(tmp_path, DISPATCH_HEAD + """
            def helper(x):
                return x.cpu()

            def get(states, args):
                return helper(states["v"])

            D = Dispatch(name="m", make_state=dict, write_ops=(),
                         read_ops=(get,))
        """)
        assert len(firing(diags, "host-sync-in-jit")) == 1

    def test_cuda_synchronize_in_step_closure_fires(self, tmp_path):
        # the step closures `core/step.py:make_step` returns are seeds
        diags = lint_pkg(tmp_path, {"core/step.py": """
            import torch

            def make_step(dispatch, spec, bw, br):
                def step(log, states, wo, wa, ro, ra):
                    torch.cuda.synchronize()
                    return log, states, wo, ro
                return step
        """})
        assert len(firing(diags, "host-sync-in-jit")) == 1

    def test_kernel_wrapper_tolist_fires_plain_route_clean(self,
                                                           tmp_path):
        # a launch-counting function of ops/replay.py is a kernel
        # wrapper; its `route(...) == "cpu"` branch (the plain
        # version, CPU tensors only) is not device path
        diags = lint_pkg(tmp_path, {"ops/replay.py": """
            import torch

            def plain(x):
                return x.tolist()

            def wrapper(x):
                if route(x) == "cpu":
                    return plain(x)
                n = x.tolist()
                KERNEL.launches += 1
                return n
        """})
        hits = firing(diags, "host-sync-in-jit")
        assert [h.line for h in hits] == [10]

    def test_host_code_and_sanctioned_exits_clean(self, tmp_path):
        # host loops may read back; the round's readback and the fence
        # are the sanctioned exits, never propagated into
        diags = lint_pkg(tmp_path, {
            "core/replica.py": """
                def _readback(t):
                    return t.cpu().numpy()

                def host_loop(x):
                    return x.item()
            """,
            "utils/fence.py": """
                import torch

                def fence(*trees):
                    torch.cuda.synchronize()
            """,
            "core/step.py": """
                from node_replication_torch.core.replica import _readback
                from node_replication_torch.utils.fence import fence

                def make_step(dispatch, spec, bw, br):
                    def step(log, states, wo, wa, ro, ra):
                        fence(states)
                        return _readback(log.tail)
                    return step
            """,
        })
        assert not firing(diags, "host-sync-in-jit")


class TestScalarCastInJit:
    def test_int_on_tensor_fires(self, tmp_path):
        diags = lint_src(tmp_path, DISPATCH_HEAD + """
            def get(states, args):
                return int(states["v"].sum()) + 1

            D = Dispatch(name="m", make_state=dict, write_ops=(),
                         read_ops=(get,))
        """)
        assert len(firing(diags, "scalar-cast-in-jit")) == 1

    def test_bool_of_tensor_param_fires(self, tmp_path):
        diags = lint_src(tmp_path, DISPATCH_HEAD + """
            def put(states, args, lanes):
                if bool(lanes.any()):
                    states["v"][0] = 1
                return args[:, 0]

            D = Dispatch(name="m", make_state=dict, write_ops=(put,),
                         read_ops=())
        """)
        assert len(firing(diags, "scalar-cast-in-jit")) == 1

    def test_constant_shape_and_host_casts_clean(self, tmp_path):
        # constants, shapes, len(), int-annotated parameters and the
        # non-tensor branch of an isinstance test are host values
        diags = lint_src(tmp_path, DISPATCH_HEAD + """
            def get(states, args, n: int = 3):
                w = int(args.shape[0]) + int(1) + int(n)
                if isinstance(n, torch.Tensor):
                    pass
                else:
                    w += int(n)
                return args[:, 0] + w + len(states)

            D = Dispatch(name="m", make_state=dict, write_ops=(),
                         read_ops=(get,))

            def host(x):
                return int(x)
        """)
        assert not firing(diags, "scalar-cast-in-jit")


class TestRawCheckifyCheck:
    def test_torch_assert_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            import torch

            def f(x):
                torch._assert(bool(x > 0), "bad")
                torch._assert_async(x > 0)
                return x
        """)
        assert len(firing(diags, "raw-checkify-check")) == 2

    def test_hand_raised_check_error_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            from node_replication_torch.utils.checks import CheckError

            def f(x):
                if x < 0:
                    raise CheckError("bad")
                return x
        """)
        assert len(firing(diags, "raw-checkify-check")) == 1

    def test_project_wrapper_clean(self, tmp_path):
        diags = lint_src(tmp_path, """
            from node_replication_torch.utils.checks import check

            def f(x):
                check(lambda: bool(x > 0), "bad")
                return x
        """)
        assert not firing(diags, "raw-checkify-check")


class TestObsInTraced:
    def test_tracer_emit_in_transition_fires(self, tmp_path):
        diags = lint_src(tmp_path, DISPATCH_HEAD + """
            from node_replication_torch.utils.trace import get_tracer

            def get(states, args):
                get_tracer().emit("evt", n=1)
                return args[:, 0]

            D = Dispatch(name="m", make_state=dict, write_ops=(),
                         read_ops=(get,))
        """)
        assert len(firing(diags, "obs-in-traced")) >= 1

    def test_metric_handle_in_transition_fires(self, tmp_path):
        diags = lint_src(tmp_path, DISPATCH_HEAD + """
            def get(states, args):
                _m_rounds.inc()
                return args[:, 0]

            D = Dispatch(name="m", make_state=dict, write_ops=(),
                         read_ops=(get,))
        """)
        assert len(firing(diags, "obs-in-traced")) == 1

    def test_host_loop_instrumentation_clean(self, tmp_path):
        diags = lint_src(tmp_path, """
            from node_replication_torch.utils.trace import get_tracer

            def exec_round(x):
                get_tracer().emit("exec-round")
                _m_rounds.inc()
                return x
        """)
        assert not firing(diags, "obs-in-traced")


class TestMutableCaptureInDispatch:
    def test_captured_tensor_index_put_fires(self, tmp_path):
        # the acceptance fixture: an in-place `index_put_` on a
        # captured tensor
        diags = lint_src(tmp_path, DISPATCH_HEAD + """
            CACHE = torch.zeros(8)

            def get(states, args):
                CACHE.index_put_((args[:, 0],), args[:, 1])
                return args[:, 0]

            D = Dispatch(name="m", make_state=dict, write_ops=(),
                         read_ops=(get,))
        """)
        hits = firing(diags, "mutable-capture-in-dispatch")
        assert len(hits) == 1 and "index_put_" in hits[0].message

    def test_read_op_state_mutation_through_view_fires(self, tmp_path):
        # a read op is pure: a subscript store through a local bound
        # to a view of its state is a mutation of the state
        diags = lint_src(tmp_path, DISPATCH_HEAD + """
            def get(states, args):
                v = states["values"]
                v[0] = 1
                return args[:, 0]

            D = Dispatch(name="m", make_state=dict, write_ops=(),
                         read_ops=(get,))
        """)
        assert len(firing(diags, "mutable-capture-in-dispatch")) == 1

    def test_out_kwarg_and_args_mutation_fire(self, tmp_path):
        # a write op may change its states, never its args or lanes
        diags = lint_src(tmp_path, DISPATCH_HEAD + """
            BUF = torch.zeros(4)

            def put(states, args, lanes):
                torch.add(args[:, 0], 1, out=BUF)
                args.add_(1)
                return args[:, 0]

            D = Dispatch(name="m", make_state=dict, write_ops=(put,),
                         read_ops=())
        """)
        assert len(firing(diags, "mutable-capture-in-dispatch")) == 2

    def test_write_op_states_and_module_functions_clean(self, tmp_path):
        # the port's write-op contract: in place on its own states
        # (directly and through a view); `torch.sort(...)` is a module
        # function, not a list's `.sort()`; fresh locals and clones
        # are the caller's own
        diags = lint_src(tmp_path, DISPATCH_HEAD + """
            def put(states, args, lanes):
                values, present = states["values"], states["present"]
                values[0] = args[0, 1]
                present.index_put_((args[:, 0],), lanes)
                states["lines"].scatter_add_(1, args, args)
                return args[:, 0]

            def plan(state, opcodes, args):
                keys, order = torch.sort(args[..., 0], stable=True)
                out = opcodes.clone()
                out.add_(1)
                out[0] = 2
                return {"keys": keys, "order": order, "out": out}

            def merge(states, plan):
                return {"values": torch.where(plan["out"] > 0,
                                              states["values"], 0)}, None

            D = Dispatch(name="m", make_state=dict, write_ops=(put,),
                         read_ops=(), window_plan=plan,
                         window_merge=merge)
        """)
        assert not firing(diags, "mutable-capture-in-dispatch")

    def test_unregistered_function_not_in_scope(self, tmp_path):
        diags = lint_src(tmp_path, """
            import torch

            CACHE = torch.zeros(4)

            def not_a_transition(state, args):
                CACHE.copy_(args)
                return state, 0
        """)
        assert not firing(diags, "mutable-capture-in-dispatch")

class TestWallClockTime:
    def test_time_time_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            import time

            def stamp():
                return time.time()
        """)
        assert len(firing(diags, "wall-clock-time")) == 1

    def test_monotonic_clocks_clean(self, tmp_path):
        diags = lint_src(tmp_path, """
            import time

            def stamp():
                return time.monotonic(), time.perf_counter()
        """)
        assert not firing(diags, "wall-clock-time")


class TestRingIndexUnmasked:
    def test_unmasked_cursor_subscript_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            def gather(log, i):
                return log.opcodes[log.tail + i]
        """)
        assert len(firing(diags, "ring-index-unmasked")) == 1

    def test_masked_through_local_alias_clean(self, tmp_path):
        # one-level dataflow: the mask lives on the alias assignment
        diags = lint_src(tmp_path, """
            def gather(log, i, mask):
                idx = (log.tail + i) & mask
                return log.opcodes[idx]

            def gather_mod(log, i, capacity):
                return log.args[(log.head + i) % capacity]
        """)
        assert not firing(diags, "ring-index-unmasked")

    def test_non_ring_arrays_not_in_scope(self, tmp_path):
        diags = lint_src(tmp_path, """
            def model(buf, tail, i):
                return buf[tail + i]
        """)
        assert not firing(diags, "ring-index-unmasked")


class TestLockDiscipline:
    def test_write_outside_lock_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.n = 0

                def inc(self):
                    with self._lock:
                        self.n += 1

                def clobber(self):
                    self.n = 5
        """)
        hits = firing(diags, "lock-discipline")
        assert len(hits) == 1 and "clobber" in hits[0].message

    def test_check_then_act_read_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.n = 0

                def maybe_reset(self):
                    if self.n:
                        with self._lock:
                            self.n = 0
        """)
        hits = firing(diags, "lock-discipline")
        assert len(hits) == 1 and "read" in hits[0].message

    def test_locked_decorator_form_clean(self, tmp_path):
        # the core/replica.py `@_locked` whole-method region idiom
        diags = lint_src(tmp_path, """
            import threading

            def _locked(fn):
                def inner(self, *a, **kw):
                    with self._lock:
                        return fn(self, *a, **kw)
                return inner

            class C:
                def __init__(self):
                    self._lock = threading.RLock()
                    self.n = 0

                @_locked
                def inc(self):
                    self.n += 1

                @_locked
                def get(self):
                    return self.n
        """)
        assert not firing(diags, "lock-discipline")

    def test_lockless_class_not_in_scope(self, tmp_path):
        diags = lint_src(tmp_path, """
            class C:
                def __init__(self):
                    self.n = 0

                def inc(self):
                    self.n += 1
        """)
        assert not firing(diags, "lock-discipline")


class TestBlockingInHandler:
    def test_sleep_in_registered_callback_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            import time

            def on_done(fut):
                time.sleep(0.1)

            def main(fut):
                fut.add_done_callback(on_done)
        """)
        hits = firing(diags, "blocking-in-handler")
        assert len(hits) == 1 and "time.sleep" in hits[0].message

    def test_future_wait_in_callback_kwarg_fires(self, tmp_path):
        # waiting on another future from the worker thread that must
        # resolve it is THE serve deadlock
        diags = lint_src(tmp_path, """
            def relay(fut):
                return other.result()

            def main(frontend, op):
                frontend.submit(op, callback=relay)
        """)
        hits = firing(diags, "blocking-in-handler")
        assert len(hits) == 1 and ".result()" in hits[0].message

    def test_inline_lambda_handler_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            import time

            def main(fut):
                fut.add_done_callback(lambda f: time.sleep(1))
        """)
        assert len(firing(diags, "blocking-in-handler")) == 1

    def test_bound_method_handler_fires(self, tmp_path):
        # class-based consumers register bound methods; the method
        # body (and self.-helpers it calls) are handler scope too
        diags = lint_src(tmp_path, """
            import time

            class Consumer:
                def _backoff(self):
                    time.sleep(0.5)

                def _on_done(self, fut):
                    self._backoff()

                def main(self, fut):
                    fut.add_done_callback(self._on_done)
        """)
        assert len(firing(diags, "blocking-in-handler")) == 1

    def test_transitive_helper_fires(self, tmp_path):
        # the handler delegates its blocking to a same-module helper
        diags = lint_src(tmp_path, """
            import time

            def backoff():
                time.sleep(0.5)

            def on_done(fut):
                backoff()

            def main(fut):
                fut.add_done_callback(on_done)
        """)
        assert len(firing(diags, "blocking-in-handler")) == 1

    def test_own_future_result_is_sanctioned(self, tmp_path):
        # reading the handler's OWN (already-resolved) future is the
        # standard done-callback idiom — never a wait
        diags = lint_src(tmp_path, """
            OUT = []

            def on_done(fut):
                OUT.append(fut.result())

            def main(fut, frontend, op):
                fut.add_done_callback(on_done)
                fut.add_done_callback(lambda f: OUT.append(f.result()))
        """)
        assert not firing(diags, "blocking-in-handler")

    def test_non_serve_callback_api_out_of_scope(self, tmp_path):
        # callback= kwargs count only on serve-shaped calls
        # (submit/call): third-party APIs with a callback kwarg must
        # not trip an ERROR-severity serve rule
        diags = lint_src(tmp_path, """
            import time
            from scipy.optimize import minimize

            def progress(xk):
                time.sleep(0.1)

            def fit(f, x0):
                return minimize(f, x0, callback=progress)
        """)
        assert not firing(diags, "blocking-in-handler")

    def test_nonblocking_handler_and_free_sleep_clean(self, tmp_path):
        # hand-off handlers are the sanctioned shape; sleeps in
        # ordinary (non-handler) code — client backoff loops, benches
        # — are out of scope
        diags = lint_src(tmp_path, """
            import time

            RESULTS = []

            def on_done(fut):
                RESULTS.append(fut)

            def main(fut):
                fut.add_done_callback(on_done)

            def client_backoff():
                time.sleep(0.01)
        """)
        assert not firing(diags, "blocking-in-handler")

class TestTimeInTraced:
    def test_clock_read_in_transition_fires(self, tmp_path):
        diags = lint_src(tmp_path, DISPATCH_HEAD + """
            import time

            def get(states, args):
                t0 = time.perf_counter()
                return args[:, 0]

            D = Dispatch(name="m", make_state=dict, write_ops=(),
                         read_ops=(get,))
        """)
        assert len(firing(diags, "time-in-traced")) == 1

    def test_clock_read_in_round_closure_fires(self, tmp_path):
        # the fused engines' round closures are device path
        diags = lint_pkg(tmp_path, {"ops/replay.py": """
            import time

            class FusedHashmapEngine:
                def round_fn(self, window, fenced=False):
                    t_build = time.monotonic()  # host: builds the closure

                    def fn(log, states, opcodes, args, count):
                        t0 = time.monotonic()
                        return log, states, t0

                    return fn
        """})
        hits = firing(diags, "time-in-traced")
        assert len(hits) == 1 and hits[0].line == 9

    def test_host_side_timing_clean(self, tmp_path):
        diags = lint_src(tmp_path, """
            import time

            def run_step(step, x):
                t0 = time.perf_counter()
                y = step(x)
                return y, time.perf_counter() - t0
        """)
        assert not firing(diags, "time-in-traced")


class TestSuppressionsAndSeverity:
    FIRING = textwrap.indent(textwrap.dedent(DISPATCH_HEAD), " " * 8) + """
        def get(states, args):
            return args[:, 0].cpu()

        D = Dispatch(name="m", make_state=dict, write_ops=(),
                     read_ops=(get,))
    """

    def test_inline_suppression(self, tmp_path):
        diags = lint_src(tmp_path, self.FIRING.replace(
            "args[:, 0].cpu()",
            "args[:, 0].cpu()  # nrlint: disable=host-sync-in-jit",
        ))
        assert not firing(diags, "host-sync-in-jit")
        assert any(
            d.rule_id == "host-sync-in-jit" and d.suppressed
            for d in diags
        )

    def test_line_above_suppression(self, tmp_path):
        diags = lint_src(tmp_path, self.FIRING.replace(
            "return args[:, 0].cpu()",
            "# nrlint: disable=host-sync-in-jit — fixture\n"
            "            return args[:, 0].cpu()",
        ))
        assert not firing(diags, "host-sync-in-jit")

    def test_suppression_is_rule_specific(self, tmp_path):
        # disabling an unrelated rule must not disarm the diagnostic
        diags = lint_src(tmp_path, self.FIRING.replace(
            "args[:, 0].cpu()",
            "args[:, 0].cpu()  # nrlint: disable=wall-clock-time",
        ))
        assert firing(diags, "host-sync-in-jit")

    def test_malformed_suppression_does_not_disarm(self, tmp_path):
        # a typo'd comment (missing '=') must neither suppress the
        # finding nor pass silently — both stay loud
        diags = lint_src(tmp_path, self.FIRING.replace(
            "args[:, 0].cpu()",
            "args[:, 0].cpu()  # nrlint: disable host-sync-in-jit",
        ))
        assert firing(diags, "host-sync-in-jit")
        assert firing(diags, "unknown-suppression")

    def test_unknown_rule_in_suppression_is_diagnosed(self, tmp_path):
        diags = lint_src(tmp_path, """
            x = 1  # nrlint: disable=not-a-rule
        """)
        assert len(firing(diags, "unknown-suppression")) == 1

    def test_min_severity_filtering(self, tmp_path, capsys):
        # wall-clock-time is a warning: fails the default gate, passes
        # --min-severity error
        p = tmp_path / "warn_only.py"
        p.write_text("import time\n\ndef f():\n    return time.time()\n")
        assert main([str(p)]) == 1
        assert main([str(p), "--min-severity", "error"]) == 0
        capsys.readouterr()

    def test_list_rules_covers_shipped_set(self, capsys):
        # the reference's 27 rule ids, so suppressions, --list-rules
        # and the docs line up across the two packages (its lint module
        # registers the nrcheck rules on import)
        import node_replication_tpu.analysis.lint  # noqa: F401
        from node_replication_tpu.analysis.rules import RULES as REF

        assert main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        assert len(RULES) == 27
        assert set(RULES) == set(REF)
        for rid in RULES:
            assert rid in out
            assert RULES[rid].severity == REF[rid].severity

class TestSwallowedWorkerException:
    def test_thread_target_pass_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            import threading

            def worker_loop(q):
                while True:
                    try:
                        q.work()
                    except Exception:
                        pass

            t = threading.Thread(target=worker_loop, args=(None,))
        """)
        assert len(firing(diags, "swallowed-worker-exception")) == 1

    def test_logging_only_still_fires(self, tmp_path):
        # a log line resolves no future and quarantines no replica
        diags = lint_src(tmp_path, """
            import logging
            import threading

            logger = logging.getLogger(__name__)

            def worker_loop(q):
                try:
                    q.work()
                except Exception:
                    logger.exception("batch failed")

            t = threading.Thread(target=worker_loop, args=(None,))
        """)
        assert len(firing(diags, "swallowed-worker-exception")) == 1

    def test_bound_method_target_and_helper_fire(self, tmp_path):
        # self._worker_loop target; the broad except hides in a
        # same-module helper the loop calls on the worker thread
        diags = lint_src(tmp_path, """
            import threading

            class Frontend:
                def start(self):
                    t = threading.Thread(target=self._worker_loop)
                    t.start()

                def _worker_loop(self):
                    while True:
                        self._run_batch()

                def _run_batch(self):
                    try:
                        self.nr.execute()
                    except Exception:
                        return None
        """)
        assert len(firing(diags, "swallowed-worker-exception")) == 1

    def test_reject_sink_reraise_and_health_clean(self, tmp_path):
        diags = lint_src(tmp_path, """
            import threading

            def rejects(batch, q):
                try:
                    q.work()
                except Exception as e:
                    for req in batch:
                        req.future._reject(e)

            def reraises(q):
                try:
                    q.work()
                except Exception:
                    raise

            def reports(q, health):
                try:
                    q.work()
                except Exception as e:
                    health.report_worker_exception(0, e)

            def typed_only(q):
                try:
                    q.work()
                except ValueError:
                    pass  # narrow except: not this rule's business

            for fn in (rejects, reraises, reports, typed_only):
                threading.Thread(target=fn).start()
        """)
        assert not firing(diags, "swallowed-worker-exception")

    def test_record_failure_helper_sanctioned(self, tmp_path):
        # the repl/ worker idiom (shipper ship loop, follower apply
        # loop): a broad except routing through `_record_failure` has
        # surfaced the failure — it stores the error for barrier/read
        # callers AND calls the health API
        diags = lint_src(tmp_path, """
            import threading

            class Shipper:
                def start(self):
                    threading.Thread(target=self._ship_loop).start()

                def _ship_loop(self):
                    try:
                        self._ship_once()
                    except Exception as e:
                        self._record_failure(e)

                def _record_failure(self, exc):
                    self._error = exc
                    self.health.report_worker_exception(0, exc)
        """)
        assert not firing(diags, "swallowed-worker-exception")

    def test_non_thread_function_is_exempt(self, tmp_path):
        # broad excepts outside worker threads are host-loop policy,
        # not this rule's concern
        diags = lint_src(tmp_path, """
            def best_effort_cleanup(path):
                try:
                    remove(path)
                except Exception:
                    pass
        """)
        assert not firing(diags, "swallowed-worker-exception")

    def test_suppression_works(self, tmp_path):
        diags = lint_src(tmp_path, """
            import threading

            def worker_loop(q):
                try:
                    q.work()
                # nrlint: disable=swallowed-worker-exception
                except Exception:
                    pass

            threading.Thread(target=worker_loop).start()
        """)
        hits = [d for d in diags
                if d.rule_id == "swallowed-worker-exception"]
        assert len(hits) == 1 and hits[0].suppressed


class TestNonDurablePublish:
    def test_rename_without_fsync_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            import os

            def publish(path, data):
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
        """)
        assert len(firing(diags, "non-durable-publish")) == 1

    def test_bare_savez_to_path_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            import numpy as np

            def snapshot(path, arr):
                np.savez(path, arr=arr)
        """)
        assert len(firing(diags, "non-durable-publish")) == 1

    def test_fsync_before_rename_clean(self, tmp_path):
        # the core/checkpoint.py:save_snapshot discipline
        diags = lint_src(tmp_path, """
            import os

            import numpy as np

            def publish(path, payload):
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    np.savez(f, **payload)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                dfd = os.open(os.path.dirname(path), os.O_RDONLY)
                os.fsync(dfd)
                os.close(dfd)
        """)
        assert not firing(diags, "non-durable-publish")

    def test_text_and_append_modes_not_in_scope(self, tmp_path):
        # CSV header rewrites and append-only journals are not
        # publish points (harness/mkbench.py:_append_csv,
        # durable/wal.py segment appends)
        diags = lint_src(tmp_path, """
            import os

            def rewrite_csv(path, rows):
                tmp = path + ".tmp"
                with open(tmp, "w") as g:
                    g.write(rows)
                os.replace(tmp, path)

            def journal(path, data):
                with open(path, "ab") as f:
                    f.write(data)
        """)
        assert not firing(diags, "non-durable-publish")

    def test_rename_with_no_prior_write_clean(self, tmp_path):
        # renaming something this scope never wrote (a compiler's
        # output, a download) is not the torn-publish pattern
        diags = lint_src(tmp_path, """
            import os

            def install(tmp, final):
                os.replace(tmp, final)
        """)
        assert not firing(diags, "non-durable-publish")


class TestRawClockInSubsystem:
    def _lint_in(self, tmp_path, subdir, source):
        import textwrap
        d = tmp_path / subdir
        d.mkdir(parents=True, exist_ok=True)
        p = d / "snippet.py"
        p.write_text(textwrap.dedent(source))
        diags, errors = run_lint([str(p)])
        assert not errors, errors
        return diags

    def test_monotonic_and_sleep_in_serve_fire(self, tmp_path):
        diags = self._lint_in(tmp_path, "serve", """
            import time

            def linger(cond, t):
                t_end = time.monotonic() + t
                time.sleep(t)
        """)
        assert len(firing(diags, "raw-clock-in-subsystem")) == 2

    def test_condition_wait_in_repl_fires(self, tmp_path):
        diags = self._lint_in(tmp_path, "repl", """
            class Shipper:
                def loop(self):
                    with self._cond:
                        self._cond.wait(0.002)
        """)
        assert len(firing(diags, "raw-clock-in-subsystem")) == 1

    def test_clock_routed_and_exempt_calls_clean(self, tmp_path):
        diags = self._lint_in(tmp_path, "fault", """
            from node_replication_torch.utils.clock import get_clock

            def timed(cond, t):
                clock = get_clock()
                t0 = clock.now()
                clock.wait(cond, t)         # routed: receiver is the clock
                clock.sleep(0.01)
                evt_like.join(t)            # thread barrier: exempt
                return clock.now() - t0
        """)
        assert not firing(diags, "raw-clock-in-subsystem")

    def test_perf_counter_duration_probe_fires_in_subsystem(
            self, tmp_path):
        # the blanket perf_counter exemption is
        # narrowed to ops/bench paths — inside a clocked subsystem a
        # duration probe measured against the OS clock is the
        # wrong-clock bug (`_run_batch`'s old t0) this rule now flags
        diags = self._lint_in(tmp_path, "serve", """
            import time

            def run_batch():
                t0 = time.perf_counter()
                do_round()
                return time.perf_counter() - t0
        """)
        assert len(firing(diags, "raw-clock-in-subsystem")) == 2

    def test_perf_counter_in_ops_path_clean(self, tmp_path):
        # ops/ (and bench/harness paths) are outside the rule's path
        # scope: kernel calibration timing legitimately reads the OS
        # clock there
        diags = self._lint_in(tmp_path, "ops", """
            import time

            def calibrate():
                t0 = time.perf_counter()
                launch()
                return time.perf_counter() - t0
        """)
        assert not firing(diags, "raw-clock-in-subsystem")

    def test_outside_scoped_subsystems_clean(self, tmp_path):
        # obs/ and utils/ (the clock module itself) are outside the
        # rule's path scope — the raw clock legitimately lives there
        diags = self._lint_in(tmp_path, "obs", """
            import time

            def stamp():
                return time.monotonic()
        """)
        assert not firing(diags, "raw-clock-in-subsystem")


class TestUnboundedGrowthInSubsystem:
    def _lint_in(self, tmp_path, subdir, source):
        import textwrap
        d = tmp_path / subdir
        d.mkdir(parents=True, exist_ok=True)
        p = d / "snippet.py"
        p.write_text(textwrap.dedent(source))
        diags, errors = run_lint([str(p)])
        assert not errors, errors
        return diags

    def test_worker_append_without_bound_fires(self, tmp_path):
        # the accumulator pattern the rule exists for: a worker loop
        # appending to an __init__-unbounded deque with no depth check
        # and no drain path anywhere in the class
        diags = self._lint_in(tmp_path, "repl", """
            import threading
            from collections import deque

            class Shipper:
                def __init__(self):
                    self._backlog = deque()
                    self._t = threading.Thread(target=self._loop)

                def _loop(self):
                    while True:
                        self._backlog.append(self.next_record())
        """)
        assert len(firing(diags, "unbounded-growth-in-subsystem")) == 1

    def test_helper_on_worker_thread_fires(self, tmp_path):
        # transitive closure: the append lives in a helper the worker
        # loop calls (same closure swallowed-worker-exception uses)
        diags = self._lint_in(tmp_path, "serve", """
            import threading

            class Frontend:
                def __init__(self):
                    self._retries = []
                    self._t = threading.Thread(target=self._loop)

                def _loop(self):
                    while True:
                        self._stash(self.take())

                def _stash(self, req):
                    self._retries.append(req)
        """)
        assert len(firing(diags, "unbounded-growth-in-subsystem")) == 1

    def test_bound_check_and_drain_clean(self, tmp_path):
        # three sanctioned shapes: a len() bound compare in the
        # appending function, a deque(maxlen=), and a container the
        # class drains (a queue, not an accumulator)
        diags = self._lint_in(tmp_path, "serve", """
            import threading
            from collections import deque

            class Frontend:
                def __init__(self):
                    self._queue = deque()
                    self._recent = deque(maxlen=64)
                    self._ready = []
                    self._t = threading.Thread(target=self._loop)

                def _loop(self):
                    while True:
                        if len(self._queue) >= self.depth:
                            continue
                        self._queue.append(self.take())
                        self._recent.append(1)
                        self._drain()

                def _drain(self):
                    while self._ready:
                        self._ready.pop()
        """)
        assert not firing(diags, "unbounded-growth-in-subsystem")

    def test_watermark_named_bound_clean(self, tmp_path):
        # a watermark comparison counts as the bound check even
        # without len() (the lag-vs-high-watermark idiom)
        diags = self._lint_in(tmp_path, "repl", """
            import threading

            class Applier:
                def __init__(self):
                    self._pending = []
                    self._t = threading.Thread(target=self._loop)

                def _loop(self):
                    while True:
                        if self.lag() > self.high_watermark:
                            continue
                        self._pending.append(self.take())
        """)
        assert not firing(diags, "unbounded-growth-in-subsystem")

    def test_outside_subsystem_and_non_worker_clean(self, tmp_path):
        # same accumulator outside serve//repl/ is out of scope; and
        # inside scope, an append on a NON-worker path (no Thread
        # target reaches it) is the client's business, not the rule's
        diags = self._lint_in(tmp_path, "harness", """
            import threading

            class Collector:
                def __init__(self):
                    self._rows = []
                    self._t = threading.Thread(target=self._loop)

                def _loop(self):
                    while True:
                        self._rows.append(self.take())
        """)
        assert not firing(diags, "unbounded-growth-in-subsystem")
        diags = self._lint_in(tmp_path, "serve", """
            class Future:
                def __init__(self):
                    self._callbacks = []

                def add_done_callback(self, fn):
                    self._callbacks.append(fn)
        """)
        assert not firing(diags, "unbounded-growth-in-subsystem")


class TestRawSocketInWorker:
    def _lint_in(self, tmp_path, subdir, source):
        import textwrap
        d = tmp_path / subdir
        d.mkdir(parents=True, exist_ok=True)
        p = d / "snippet.py"
        p.write_text(textwrap.dedent(source))
        diags, errors = run_lint([str(p)])
        assert not errors, errors
        return diags

    def test_timeoutless_accept_and_recv_fire(self, tmp_path):
        # the wedge pattern: a repl/ worker loop blocking on a socket
        # with no timeout anywhere — a half-open peer parks the thread
        # forever, past every stop flag and join
        diags = self._lint_in(tmp_path, "repl", """
            import socket
            import threading

            class Server:
                def __init__(self):
                    self._sock = socket.socket()
                    self._t = threading.Thread(target=self._loop)

                def _loop(self):
                    while True:
                        conn, _ = self._sock.accept()
                        self._serve(conn)

                def _serve(self, conn):
                    return conn.recv(4096)
        """)
        assert len(firing(diags, "raw-socket-in-worker")) == 2

    def test_settimeout_discipline_clean(self, tmp_path):
        # construction-site settimeout sanctions the receiver (the
        # transport.py shape: configure once, block with a deadline)
        diags = self._lint_in(tmp_path, "repl", """
            import socket
            import threading

            class Server:
                def __init__(self):
                    self._sock = socket.socket()
                    self._sock.settimeout(0.2)
                    self._t = threading.Thread(target=self._loop)

                def _loop(self):
                    while True:
                        conn, _ = self._sock.accept()
                        conn.settimeout(5.0)
                        self._serve(conn)

                def _serve(self, conn):
                    return conn.recv(4096)
        """)
        assert not firing(diags, "raw-socket-in-worker")

    def test_non_worker_and_non_socket_clean(self, tmp_path):
        # a request helper on the CALLER's thread is the caller's
        # timeout problem, and a non-socket `.recv` (a pipe-like
        # object) is out of scope
        diags = self._lint_in(tmp_path, "repl", """
            import threading

            class Client:
                def request(self, sock, payload):
                    sock.send(payload)
                    return sock.recv(4096)

            class Pump:
                def __init__(self):
                    self._t = threading.Thread(target=self._loop)

                def _loop(self):
                    while True:
                        self._chan.recv(1)
        """)
        assert not firing(diags, "raw-socket-in-worker")

    def test_outside_repl_clean(self, tmp_path):
        diags = self._lint_in(tmp_path, "harness", """
            import socket
            import threading

            class Server:
                def __init__(self):
                    self._sock = socket.socket()
                    self._t = threading.Thread(target=self._loop)

                def _loop(self):
                    while True:
                        self._sock.accept()
        """)
        assert not firing(diags, "raw-socket-in-worker")

_PROJECT = {}


def port_project():
    """The port's whole-package Project, built once per file (one
    build is ~10 s; the gate and the graph differential share it)."""
    if "p" not in _PROJECT:
        import node_replication_torch

        from node_replication_torch.analysis.lint import (
            build_project,
            collect_files,
        )

        pkg = os.path.dirname(node_replication_torch.__file__)
        files = collect_files([pkg])
        _PROJECT["files"] = files
        _PROJECT["p"] = build_project(files)
    return _PROJECT["files"], _PROJECT["p"]


class TestRepoIsClean:
    def test_package_lints_clean(self):
        # the CI gate, as a test: every violation in the port is either
        # fixed or carries a justified suppression. Resolve the package
        # directory from the import (a cwd-relative path would collect
        # 0 files — and pass vacuously — when pytest runs from outside
        # the repo root) and require a real file count.
        files, (modules, project, errors) = port_project()
        assert len(files) > 40
        assert not errors
        diags, _ = run_lint(files, project=project)
        bad = [d.format() for d in diags if not d.suppressed]
        assert not bad, "\n".join(bad)

    def test_device_path_covers_the_seeds(self):
        # the device-path inference reaches each seed family of the
        # port: a Dispatch transition, the step closures, the fused
        # engines' round closures, the kernel wrappers — and neither
        # sanctioned host exit
        import ast

        _, (modules, project, _) = port_project()
        by = {m.module_name: m for m in modules}

        def fn(mod, name, cls=None):
            tree = by[f"node_replication_torch.{mod}"].tree
            scope = tree.body
            if cls:
                scope = next(n for n in tree.body
                             if isinstance(n, ast.ClassDef)
                             and n.name == cls).body
            return next(n for n in scope if isinstance(
                n, ast.FunctionDef) and n.name == name)

        def nested(f):
            return [n for n in ast.walk(f) if n is not f
                    and isinstance(n, ast.FunctionDef)]

        hm = fn("models.hashmap", "make_hashmap")
        put = next(n for n in nested(hm) if n.name == "put")
        assert project.is_dispatch_fn(put)
        assert project.is_dispatch_write_fn(put)
        assert project.is_device_scope(put)
        for f in nested(fn("core.step", "make_step")):
            assert project.is_device_scope(f)
        for f in nested(fn("ops.replay", "round_fn", "FusedHashmapEngine")):
            assert project.is_device_scope(f)
        for name in ("hashmap_fused_round_model", "hashmap_replay"):
            assert project.is_device_scope(fn("ops.replay", name))
        for mod, name in (("ops.vspace", "vspace_fused_round"),
                          ("ops.oahashmap", "oahashmap_replay")):
            assert project.is_device_scope(fn(mod, name))
        assert not project.is_device_scope(fn("core.replica", "_readback"))
        assert not project.is_device_scope(fn("utils.fence", "fence"))
        # the plain versions run only on the CPU route
        for name in ("hashmap_fused_round_plain",
                     "hashmap_fused_round_model_plain"):
            assert not project.is_device_scope(fn("ops.replay", name))

class TestHostTransferInShardedPath:
    def test_state_gather_in_exec_path_fires(self, tmp_path):
        diags = lint_in(tmp_path, "core", """
            import numpy as np

            def _exec_round(self):
                snap = np.asarray(self.states)      # whole-fleet gather
                ring = self.log.opcodes.cpu()
                return snap, ring
        """)
        assert len(firing(diags, "host-transfer-in-sharded-path")) == 2

    def test_item_and_to_cpu_on_placed_state_fire(self, tmp_path):
        diags = lint_in(tmp_path, "parallel", """
            def shmap_exec(fleet, states):
                a = states[0].item()
                b = fleet.shards[0].states["values"].to("cpu")
                c = fleet._placed.states["values"].to(device="cpu")
                return a, b, c
        """)
        assert len(firing(diags, "host-transfer-in-sharded-path")) == 3

    def test_cursor_readbacks_and_out_of_scope_clean(self, tmp_path):
        # cursor readbacks are the exec loop's sanctioned host syncs;
        # functions outside the exec-path names (ring_slice-style host
        # bridges, checkpointing) are out of scope by design; a device
        # move that is not to the host is no transfer
        diags = lint_in(tmp_path, "core", """
            import numpy as np

            def _exec_round(self):
                cur = self.log.ltails.cpu().numpy()   # cursors: fine
                tail = int(self.log.tail)
                moved = self.states["values"].to("cuda:1")
                return cur, tail, moved

            def ring_slice(spec, log, start, stop):
                return log.opcodes.cpu()            # host bridge: fine

            def save_snapshot(path, states):
                return np.asarray(states)           # checkpoint: fine
        """)
        assert not firing(diags, "host-transfer-in-sharded-path")

    def test_outside_core_parallel_clean(self, tmp_path):
        # the serve/obs layers read states through the wrapper's host
        # APIs — only core/ and parallel/ exec paths are in scope
        diags = lint_in(tmp_path, "serve", """
            import numpy as np

            def exec_probe(self):
                return np.asarray(self.states), self.states.cpu()
        """)
        assert not firing(diags, "host-transfer-in-sharded-path")


class TestAliasedPallasPlanes:
    """The torch reading of the reference's aliased-planes rule: one
    tensor, or views of one storage, as two planes of one launch in an
    ops/ wrapper, unless the kernel's csrc source declares the plane
    written in place."""

    LAUNCH = """
        import torch

        def wrapper(lib, values, present, ring):
            {prelude}
            err = lib.nr_round({args})
            KERNEL.launches += 1
            return err
    """

    def _lint(self, tmp_path, args, prelude="pass", cu=None):
        files = {"ops/k.py": self.LAUNCH.format(prelude=prelude,
                                                args=args)}
        if cu is not None:
            files["csrc/k.cu"] = cu
        return lint_pkg(tmp_path, files)

    def test_same_tensor_as_two_planes_fires(self, tmp_path):
        diags = self._lint(tmp_path, "values.data_ptr(), "
                                     "present.data_ptr(), "
                                     "values.data_ptr()")
        hits = firing(diags, "aliased-pallas-planes")
        assert len(hits) == 1 and "planes 0 and 2" in hits[0].message

    def test_views_of_one_storage_fire(self, tmp_path):
        # a transposed view bound in the wrapper, and a row of the
        # ring: both alias the storage already passed
        diags = self._lint(
            tmp_path,
            "values.data_ptr(), vt.data_ptr(), ring.data_ptr(), "
            "ring[1:].data_ptr()",
            prelude="vt = values.T")
        assert len(firing(diags, "aliased-pallas-planes")) == 2

    def test_fresh_outputs_and_list_elements_clean(self, tmp_path):
        # the sanctioned shape: fresh output planes, also as elements
        # of a list of new tensors (`outs[0]`, `outs[1]` are two)
        diags = self._lint(
            tmp_path,
            "values.data_ptr(), outs[0].data_ptr(), present.data_ptr(), "
            "outs[1].data_ptr(), v2.data_ptr()",
            prelude="outs = [torch.empty_like(t) for t in "
                    "(values, present)]; v2 = torch.empty_like(values)")
        assert not firing(diags, "aliased-pallas-planes")

    def test_declared_in_place_plane_clean(self, tmp_path):
        # the kernel's source declares the plane written in place
        cu = """
            // in-place: ring_in, ring_out
            extern "C" int nr_round(const int* values, int* ring_in,
                                    int* ring_out) {
                return 0;
            }
        """
        diags = self._lint(tmp_path, "values.data_ptr(), ring.data_ptr(), "
                                     "ring.data_ptr()", cu=cu)
        assert not firing(diags, "aliased-pallas-planes")

    def test_undeclared_plane_of_a_declaring_source_fires(self, tmp_path):
        cu = """
            // in-place: ring_in
            extern "C" int nr_round(const int* values, int* ring_in,
                                    int* out) {
                return 0;
            }
        """
        diags = self._lint(tmp_path, "values.data_ptr(), "
                                     "present.data_ptr(), "
                                     "values.data_ptr()", cu=cu)
        assert len(firing(diags, "aliased-pallas-planes")) == 1

    def test_view_bound_in_enclosing_function_fires(self, tmp_path):
        # closure-level resolution: the view is bound in the enclosing
        # function, the launch made in the nested round closure
        diags = lint_pkg(tmp_path, {"ops/k.py": """
            def build(lib, values):
                vt = values.T

                def launch(x):
                    return lib.nr_round(values.data_ptr(), vt.data_ptr())

                return launch
        """})
        assert len(firing(diags, "aliased-pallas-planes")) == 1

    def test_outside_ops_clean(self, tmp_path):
        diags = lint_src(tmp_path, """
            def wrapper(lib, values):
                return lib.nr_round(values.data_ptr(), values.data_ptr())
        """)
        assert not firing(diags, "aliased-pallas-planes")

class TestUnboundedMetricCardinality:
    def _lint_in(self, tmp_path, subdir, source):
        import textwrap
        d = tmp_path / subdir
        d.mkdir(parents=True, exist_ok=True)
        p = d / "snippet.py"
        p.write_text(textwrap.dedent(source))
        diags, errors = run_lint([str(p)])
        assert not errors, errors
        return diags

    def test_pos_and_request_id_interpolation_fires(self, tmp_path):
        # the leak pattern: one instrument minted per record — the
        # registry (and every exporter scrape) grows without bound
        diags = self._lint_in(tmp_path, "serve", """
            from node_replication_torch.obs.metrics import get_registry

            def note(reg, rec, request_id):
                reg.counter(f"repl.record.{rec.pos}").inc()
                reg.gauge("lat.req.{}".format(request_id)).set(1.0)
                get_registry().histogram("h.%d" % rec.seq).observe(0.1)
        """)
        assert len(firing(diags, "unbounded-metric-cardinality")) == 3

    def test_bounded_dimensions_clean(self, tmp_path):
        # rid (per-replica) and log_idx (per-log) are fleet-bounded
        # dimensions — the sanctioned serve.queue_depth.r<rid> shape —
        # and a constant name is the normal case
        diags = self._lint_in(tmp_path, "serve", """
            from node_replication_torch.obs.metrics import get_registry

            def wire(reg, rid, log_idx):
                reg.gauge(f"serve.queue_depth.r{rid}").set(0)
                reg.counter(f"cnr.log{log_idx}.rounds").inc()
                get_registry().counter("serve.submitted").inc()
        """)
        assert not firing(diags, "unbounded-metric-cardinality")

    def test_non_registry_receiver_clean(self, tmp_path):
        # .counter() on something that is not the metrics registry
        # (a collections.Counter factory, a stats helper) is out of
        # scope — the rule keys on registry-shaped receivers
        diags = self._lint_in(tmp_path, "harness", """
            def tally(stats, pos):
                return stats.counter(f"bucket-{pos}")
        """)
        assert not firing(diags, "unbounded-metric-cardinality")

    def test_obs_package_out_of_scope(self, tmp_path):
        # the registry's own implementation/fixtures legitimately
        # build names from variables
        diags = self._lint_in(tmp_path, "obs", """
            def make(reg, pos):
                return reg.counter(f"fixture.{pos}")
        """)
        assert not firing(diags, "unbounded-metric-cardinality")

    def test_suppression_works(self, tmp_path):
        diags = self._lint_in(tmp_path, "repl", """
            def note(reg, pos):
                reg.counter(f"x.{pos}").inc()  # nrlint: disable=unbounded-metric-cardinality — fixture
        """)
        assert not firing(diags, "unbounded-metric-cardinality")

class TestDeviceSyncInAssembly:
    """Host syncs on the serve pipeline's assembly stage re-serialize
    exactly the overlap the pipeline exists to buy. Rooted at
    `_assemble`, closed over same-module helpers (the
    blocking-in-handler closure machinery)."""

    def test_item_in_assemble_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            class Frontend:
                def _assemble(self, rid, q, batch):
                    depth = self._nr.log.tail.item()
                    return depth
        """)
        assert len(firing(diags, "device-sync-in-assembly")) == 1

    def test_blocking_helper_via_closure_fires(self, tmp_path):
        # a helper reachable from _assemble is still assembly-stage
        # code: delegating the synchronize does not launder it
        diags = lint_src(tmp_path, """
            import torch

            class Frontend:
                def _peek(self, arr):
                    torch.cuda.synchronize()
                    return arr.cpu()

                def _assemble(self, rid, q, batch):
                    return self._peek(batch)
        """)
        assert len(firing(diags, "device-sync-in-assembly")) == 2

    def test_future_result_in_assemble_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            class Frontend:
                def _assemble(self, rid, q, batch):
                    return batch[0].future.result()
        """)
        assert len(firing(diags, "device-sync-in-assembly")) == 1

    def test_clean_assembly_and_out_of_closure_sync_clean(
            self, tmp_path):
        # the real assembly shape (sweep + begin + handoff) is clean,
        # and a sync in the COMPLETION stage — not reachable from
        # _assemble — is exactly where the wait belongs
        diags = lint_src(tmp_path, """
            class Frontend:
                def _sweep(self, batch):
                    return [r for r in batch if r.live]

                def _assemble(self, rid, q, batch):
                    live = self._sweep(batch)
                    return self._nr.begin_mut_batch(
                        [r.op for r in live], rid
                    )

                def _complete(self, rid, q, staged):
                    resps = self._nr.finish_mut_batch(staged.pending)
                    return [int(r) for r in resps.cpu()]

                def _deliver(self, arr):
                    return arr.item()  # completion-side: fine
        """)
        assert not firing(diags, "device-sync-in-assembly")

    def test_module_without_assemble_clean(self, tmp_path):
        diags = lint_src(tmp_path, """
            def worker(arr):
                return arr.item()
        """)
        assert not firing(diags, "device-sync-in-assembly")

class TestUnnamedWorkerThread:
    """Rule 20: anonymous threads inside the serve/repl/fault/
    durable/obs subsystems collapse into the sampling profiler's
    'other' role bucket (`obs/profile.role_of`), so subsystem spawns
    must carry `name=`. Tests/benches/examples are out of scope."""

    def _lint_in(self, tmp_path, subdir, source):
        import textwrap
        d = tmp_path / subdir
        d.mkdir(parents=True, exist_ok=True)
        p = d / "snippet.py"
        p.write_text(textwrap.dedent(source))
        diags, errors = run_lint([str(p)])
        assert not errors, errors
        return diags

    def test_unnamed_thread_in_serve_fires(self, tmp_path):
        diags = self._lint_in(tmp_path, "serve", """
            import threading

            def spawn(q):
                t = threading.Thread(target=q.drain, daemon=True)
                t.start()
                return t
        """)
        assert len(firing(diags, "unnamed-worker-thread")) == 1

    def test_unnamed_thread_in_obs_fires(self, tmp_path):
        diags = self._lint_in(tmp_path, "obs", """
            from threading import Thread

            def spawn(fn):
                return Thread(target=fn)
        """)
        assert len(firing(diags, "unnamed-worker-thread")) == 1

    def test_named_thread_clean(self, tmp_path):
        diags = self._lint_in(tmp_path, "repl", """
            import threading

            def spawn(rid, loop):
                return threading.Thread(
                    target=loop, name=f"repl-apply-{rid}", daemon=True,
                )
        """)
        assert not firing(diags, "unnamed-worker-thread")

    def test_out_of_scope_module_clean(self, tmp_path):
        # scratch threads in test/bench-style modules don't feed the
        # profiler's role table — out of the rule's scope
        diags = lint_src(tmp_path, """
            import threading

            def spawn(fn):
                return threading.Thread(target=fn)
        """)
        assert not firing(diags, "unnamed-worker-thread")


class TestUnroutedKeyInShardPath:
    def _lint_in(self, tmp_path, subdir, source):
        import textwrap
        d = tmp_path / subdir
        d.mkdir(parents=True, exist_ok=True)
        p = d / "snippet.py"
        p.write_text(textwrap.dedent(source))
        diags, errors = run_lint([str(p)])
        assert not errors, errors
        return diags

    def test_unrouted_submit_fires(self, tmp_path):
        # the mis-route pattern: a shard/ helper that hands ops to a
        # frontend with no ShardMap lookup anywhere in the function —
        # one stale-map refactor away from writing into the wrong
        # keyspace slice
        diags = self._lint_in(tmp_path, "shard", """
            class Proxy:
                def forward(self, fe, ops):
                    futs = [fe.submit(op) for op in ops]
                    return [f.result() for f in futs]

                def forward_round(self, nr, opcodes, args):
                    return nr.execute_mut_batch(opcodes, args)
        """)
        assert len(firing(diags, "unrouted-key-in-shard-path")) == 2

    def test_routed_submit_clean(self, tmp_path):
        # the sanctioned shape (shard/router.py LocalBackend): the
        # same function re-verifies each op's owner through the map
        # before staging anything
        diags = self._lint_in(tmp_path, "shard", """
            class Backend:
                def submit_batch(self, fe, ops):
                    for op in ops:
                        if self._map.shard_of_op(op) != self.shard:
                            raise ValueError("wrong shard")
                    return [fe.submit(op) for op in ops]

                def route(self, fe, ops):
                    groups = self._map.split_batch(ops)
                    for shard, entries in groups.items():
                        for _i, op in entries:
                            fe.submit(op)
        """)
        assert not firing(diags, "unrouted-key-in-shard-path")

    def test_outside_shard_clean(self, tmp_path):
        # the serve plane itself has no sharding contract to honor
        diags = self._lint_in(tmp_path, "serve", """
            class Caller:
                def call(self, fe, op):
                    return fe.submit(op).result()
        """)
        assert not firing(diags, "unrouted-key-in-shard-path")


class TestTxnAckBeforeDecision:
    def _lint_in(self, tmp_path, subdir, source):
        import textwrap
        d = tmp_path / subdir
        d.mkdir(parents=True, exist_ok=True)
        p = d / "snippet.py"
        p.write_text(textwrap.dedent(source))
        diags, errors = run_lint([str(p)])
        assert not errors, errors
        return diags

    def test_ack_without_decision_fires(self, tmp_path):
        # the lost-commit-point bug: the coordinator resolves the
        # caller's future after prepare with NO durable decision — a
        # crash right after the ack presumed-aborts a transaction the
        # caller was told committed
        diags = self._lint_in(tmp_path, "shard", """
            class Coordinator:
                def run(self, txn, groups, fut):
                    for shard, ops in groups.items():
                        self._backend(shard).prepare(txn, self.gen, ops)
                    results = self._commit_all(txn, groups)
                    fut.set_result(results)
        """)
        assert len(firing(diags, "txn-ack-before-decision")) == 1

    def test_verb_string_dispatch_fires(self, tmp_path):
        # the prepare step hidden behind a verb-string dispatch
        # helper is still the prepare step
        diags = self._lint_in(tmp_path, "shard", """
            class Coordinator:
                def run(self, txn, groups, fut):
                    for shard, ops in groups.items():
                        self._verb(shard, "prepare", txn, ops=ops)
                    fut.set_result(self._commit_all(txn, groups))
        """)
        assert len(firing(diags, "txn-ack-before-decision")) == 1

    def test_decision_before_ack_clean(self, tmp_path):
        # the sanctioned shape (shard/txn.py TxnCoordinator): the
        # decision document is durably published BEFORE any future
        # resolves
        diags = self._lint_in(tmp_path, "shard", """
            class Coordinator:
                def run(self, txn, groups, fut):
                    for shard, ops in groups.items():
                        self._backend(shard).prepare(txn, self.gen, ops)
                    self.decisions.publish(txn, "commit",
                                           shards=sorted(groups))
                    fut.set_result(self._commit_all(txn, groups))
        """)
        assert not firing(diags, "txn-ack-before-decision")

    def test_set_exception_exempt(self, tmp_path):
        # failing the caller never claims the transaction decided
        diags = self._lint_in(tmp_path, "shard", """
            class Coordinator:
                def run(self, txn, groups, fut):
                    try:
                        for shard, ops in groups.items():
                            self._backend(shard).prepare(txn, 0, ops)
                    except Exception as e:
                        fut.set_exception(e)
        """)
        assert not firing(diags, "txn-ack-before-decision")

    def test_outside_shard_clean(self, tmp_path):
        # only the shard/ txn plane carries the 2PC contract
        diags = self._lint_in(tmp_path, "serve", """
            class Pipeline:
                def run(self, stage, fut):
                    stage.prepare()
                    fut.set_result(stage.flush())
        """)
        assert not firing(diags, "txn-ack-before-decision")

# ------------------------------------------------------------ differentials

#: the reference's fixture classes of the 13 rules that involve no JAX
#: (tests/test_analysis.py) and of the 5 nrcheck rules
#: (tests/test_concurrency.py)
_PLAIN_RULE_CLASSES = {
    "test_analysis.py": (
        "TestWallClockTime", "TestRingIndexUnmasked", "TestLockDiscipline",
        "TestBlockingInHandler", "TestSwallowedWorkerException",
        "TestNonDurablePublish", "TestRawClockInSubsystem",
        "TestUnboundedGrowthInSubsystem", "TestRawSocketInWorker",
        "TestUnboundedMetricCardinality", "TestUnnamedWorkerThread",
        "TestUnroutedKeyInShardPath", "TestTxnAckBeforeDecision",
    ),
    "test_concurrency.py": (
        "TestGuardedByInference", "TestLockOrder", "TestAnnotationDiags",
        "TestConditionWaitRule", "TestLockHeldAcrossBlockingCall",
    ),
}
PLAIN_RULES = (
    "wall-clock-time", "ring-index-unmasked", "lock-discipline",
    "blocking-in-handler", "swallowed-worker-exception",
    "non-durable-publish", "raw-clock-in-subsystem",
    "unbounded-growth-in-subsystem", "raw-socket-in-worker",
    "unbounded-metric-cardinality", "unnamed-worker-thread",
    "unrouted-key-in-shard-path", "txn-ack-before-decision",
    "nrcheck-guarded-by", "nrcheck-lock-order", "nrcheck-annotation",
    "condition-wait-without-predicate-loop",
    "lock-held-across-blocking-call",
)


def _reference_fixtures() -> list:
    """`(id, subdir, source)` for every snippet the reference's tests of
    those classes lint: the string handed to `lint_src` / `analyze_src`
    / `_lint_in` (evaluated against the test module's constants, so
    `SHARED_CLASS + ...` fixtures come along)."""
    import ast

    here = os.path.dirname(os.path.abspath(__file__))
    out = []
    for fname, classes in _PLAIN_RULE_CLASSES.items():
        with open(os.path.join(here, fname)) as fh:
            tree = ast.parse(fh.read())
        consts = {}
        for node in tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)):
                consts[node.targets[0].id] = node.value.value
        for cls in tree.body:
            if not (isinstance(cls, ast.ClassDef) and cls.name in classes):
                continue
            for fn in cls.body:
                if not isinstance(fn, ast.FunctionDef):
                    continue
                k = 0
                for call in ast.walk(fn):
                    if not isinstance(call, ast.Call):
                        continue
                    f = call.func
                    name = f.id if isinstance(f, ast.Name) else (
                        f.attr if isinstance(f, ast.Attribute) else None)
                    if name in ("lint_src", "analyze_src") and \
                            len(call.args) >= 2:
                        subdir, expr = None, call.args[1]
                    elif name == "_lint_in" and len(call.args) >= 3:
                        subdir = ast.literal_eval(call.args[1])
                        expr = call.args[2]
                    else:
                        continue
                    src = eval(compile(ast.Expression(expr), fname,
                                       "eval"), dict(consts))
                    out.append((f"{cls.name}.{fn.name}#{k}", subdir,
                                textwrap.dedent(src)))
                    k += 1
    return out


_FIXTURES = _reference_fixtures()


def _key(d, root):
    return (d.rule_id, os.path.relpath(d.path, root), d.line, d.col,
            d.severity, d.suppressed)


class TestDifferential:
    def test_fixture_harvest_covers_every_plain_rule(self):
        # the harvest found the reference's fixtures, and the 18 rules
        # are registered under the reference's ids
        assert len(_FIXTURES) > 60
        assert set(PLAIN_RULES) <= set(RULES)

    @pytest.mark.parametrize(
        "subdir,source", [f[1:] for f in _FIXTURES],
        ids=[f[0] for f in _FIXTURES])
    def test_same_diagnostics_as_the_reference(self, tmp_path, subdir,
                                               source):
        # the 13 rules that involve no JAX and the 5 nrcheck rules are
        # the reference's: the same snippet gives the same (rule, line,
        # col, severity, suppressed) list through both engines
        from node_replication_tpu.analysis.lint import (
            run_lint as ref_run_lint,
        )

        d = tmp_path / subdir if subdir else tmp_path
        d.mkdir(parents=True, exist_ok=True)
        p = d / "snippet.py"
        p.write_text(source)
        sel = set(PLAIN_RULES)
        got, e1 = run_lint([str(p)], select=sel)
        want, e2 = ref_run_lint([str(p)], select=sel)
        assert not e1 and not e2
        assert sorted(_key(x, tmp_path) for x in got) == \
            sorted(_key(x, tmp_path) for x in want)

    def test_plain_rule_fixtures_fire_somewhere(self, tmp_path):
        # the comparison above is not vacuous: across the harvested
        # fixtures every one of the 18 rules fires at least once
        seen = set()
        for i, (_, subdir, src) in enumerate(_FIXTURES):
            d = tmp_path / str(i) / (subdir or "")
            d.mkdir(parents=True, exist_ok=True)
            p = d / "snippet.py"
            p.write_text(src)
            diags, _ = run_lint([str(p)], select=set(PLAIN_RULES))
            seen |= {x.rule_id for x in diags}
        assert seen == set(PLAIN_RULES)


#: nodes only the port's static lock-order graph has, with the reason
PORT_ONLY_NODES = {
    # obs/export.py: one torch.profiler per process, so one device
    # capture per process (the reference's exporter has no capture)
    "export._capture_lock",
    # ops/kernel_lib.py: the CUDA libraries build and bind once per
    # process (a plain threading.Lock: no TPU counterpart)
    "kernel_lib._lock",
}
#: edges only the port's graph has, each declared where the nesting is
#: (the reference nests the same way, undeclared); the port's checked
#: runs record them: a commit applies the intent through the frontend
#: and reads the WAL under the participant lock (shard/txn.py), and
#: `profile_start` builds the profiler, whose gauges the registry
#: creates, under the exporter lock (obs/export.py)
PORT_ONLY_EDGES = {
    ("TxnParticipant._lock", "_SubmissionQueue._lock"),
    ("TxnParticipant._lock", "ServeFuture._cond"),
    ("TxnParticipant._lock", "WriteAheadLog._lock"),
    ("MetricsExporter._lock", "MetricsRegistry._lock"),
}


class TestStaticGraphDifferential:
    def test_port_graph_equals_the_reference_graph(self):
        # the port's static lock-order graph over its own package,
        # computed by the port, equals the reference's over
        # node_replication_tpu, computed by the reference, apart from
        # the pinned port-only nodes and edges
        import node_replication_tpu
        from node_replication_tpu.analysis import (
            concurrency as ref_concurrency,
        )
        from node_replication_tpu.analysis.lint import (
            build_project as ref_build,
        )
        from node_replication_tpu.analysis.lint import (
            collect_files as ref_collect,
        )

        from node_replication_torch.analysis import concurrency

        _, (_, project, _) = port_project()
        port = concurrency.analyze(project).graph_json()
        pkg = os.path.dirname(node_replication_tpu.__file__)
        _, ref_project, _ = ref_build(ref_collect([pkg]))
        ref = ref_concurrency.analyze(ref_project).graph_json()
        pe = {tuple(e) for e in port["edges"]}
        re_ = {tuple(e) for e in ref["edges"]}
        assert pe - re_ == PORT_ONLY_EDGES
        assert re_ <= pe
        assert set(port["nodes"]) - set(ref["nodes"]) == PORT_ONLY_NODES
        assert set(ref["nodes"]) <= set(port["nodes"])
        assert port["cycles"] == ref["cycles"] == []


class TestTorchAcceptance:
    """The torch-aware rules fire on the acceptance torch fixtures and
    stay silent on `torch.sort(...)`."""

    def test_cuda_synchronize_under_a_held_subsystem_lock(self, tmp_path):
        diags = lint_in(tmp_path, "serve", """
            import threading

            import torch

            class Worker:
                def __init__(self):
                    self._lock = threading.Lock()

                def flush(self):
                    with self._lock:
                        torch.cuda.synchronize()
                        self.x = self.t.item()
                        self.y = self.t.cpu()
        """)
        hits = firing(diags, "lock-held-across-blocking-call")
        assert len(hits) == 3

    def test_torch_sort_in_window_plan_is_not_a_mutation(self, tmp_path):
        # the reference's engine reads `torch.sort` as a list `.sort()`
        # of a captured `torch`; the port's does not
        from node_replication_tpu.analysis.lint import (
            run_lint as ref_run_lint,
        )

        src = DISPATCH_HEAD + """
            def plan(state, opcodes, args):
                keys, order = torch.sort(args[..., 0], stable=True)
                return {"keys": keys, "order": order}

            D = Dispatch(name="m", make_state=dict, write_ops=(),
                         read_ops=(), window_plan=plan)
        """
        diags = lint_src(tmp_path, src)
        assert not firing(diags, "mutable-capture-in-dispatch")
        ref, _ = ref_run_lint([str(tmp_path / "snippet.py")])
        assert firing(ref, "mutable-capture-in-dispatch")

    def test_port_models_have_no_mutation_findings(self):
        # the seven `torch.sort` false positives the reference's rule
        # raised over the port's models stay away
        _, (modules, project, _) = port_project()
        files = [m.path for m in modules if "/models/" in m.path]
        diags, _ = run_lint(files, select={"mutable-capture-in-dispatch"},
                            project=None)
        assert not [d for d in diags if not d.suppressed]

    def test_package_is_stdlib_only(self):
        # analysis/ imports neither torch nor jax nor the reference
        import ast

        import node_replication_torch.analysis as pkg

        d = os.path.dirname(pkg.__file__)
        for f in sorted(os.listdir(d)):
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    root = n.split(".")[0]
                    assert root not in ("torch", "jax", "jaxlib",
                                        "numpy", "node_replication_tpu"), \
                        (f, n)
