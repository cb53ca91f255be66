"""The linearizable checker front end (reference: checker.clj:185-216).

The port's copy of the JAX package's ``checker.linearizable``.  It
chooses an analysis backend by ``algorithm`` the way the reference
chooses between knossos's ``:linear``/``:wgl``/``competition`` engines;
the values are the JAX package's, so a test map moves between the
packages unchanged:

  * ``"wgl"``          — the CPU DFS oracle (``checker.wgl_cpu``);
  * ``"sweep"``        — the CPU configuration-set sweep (the device
    engines' semantics oracle);
  * ``"tpu"``          — the chunked device engine (``ops.wgl.analysis``:
    carried-frontier chunk scans, exact unless ``kernel-opts`` asks for
    ``fast``), which here runs on the CUDA card; the value keeps its
    name for parity with the JAX package;
  * ``"competition"``  — the fastest-first ladder, mirroring
    knossos.competition's race with a deterministic order: (0) the
    device greedy witness walk (``wgl.greedy_analysis``); (1) the async
    beam engine at an escalating capacity ladder (``async-capacity``,
    default (256, 1024)) — a surviving frontier is a witness (True), a
    lossless death is confirmed by the exact CPU sweep bounded to the
    failure prefix (the kernel's ``bar-opid``); (2) on "unknown", the
    CPU DFS; (3) still unknown → the chunked exact device engine.

The checker's opts take ``"device"``: the CUDA card unless it is
``"cpu"``, forwarded to every device engine it calls.  On failure,
``final-paths`` / ``configs`` are truncated to 10 entries, as the
reference does (checker.clj:213-216), and ``check`` renders
``linear.svg`` into the test's store directory.

The check's opts carry the services, as in the JAX package: the shared
``"deadline"`` (``checker.resolve_opts`` makes it from the test map's
``"check-deadline"``) reaches every device engine, and ``check_batch``
passes ``"checkpoint-dir"`` and ``"resume?"`` to the ladder.  Results
carry a ``provenance`` block, and with a store configured (``name``,
``start-time-str`` in the test map) each writes an evidence bundle
(``obs.provenance.emit``) and records it under ``"evidence"``.
"""

from __future__ import annotations

from typing import Mapping

from jepsen_tpu_torch import models as m
from jepsen_tpu_torch.checker import Checker, UNKNOWN
from jepsen_tpu_torch.checker import wgl_cpu
from jepsen_tpu_torch.obs import provenance as _prov


def _resolve_model(model) -> m.Model:
    if isinstance(model, str):
        return m.model(model)
    return model


class Linearizable(Checker):
    def __init__(self, opts: Mapping):
        if "model" not in opts or opts["model"] is None:
            raise ValueError(
                f"the linearizable checker requires a model, got {opts.get('model')!r}"
            )
        self.model = _resolve_model(opts["model"])
        self.algorithm = opts.get("algorithm", "competition")
        self.kernel_opts = dict(opts.get("kernel-opts", {}))
        self.device = opts.get("device")

    def _analyze(self, history, deadline=None):
        if self.algorithm == "wgl":
            return _prov.attach(
                wgl_cpu.dfs_analysis(self.model, history),
                [{"event": "engine.dfs"}], engine={"engine": "wgl-dfs"})
        if self.algorithm == "sweep":
            return _prov.attach(
                wgl_cpu.sweep_analysis(self.model, history),
                [{"event": "engine.sweep"}], engine={"engine": "wgl-sweep"})
        from jepsen_tpu_torch.ops import wgl as wgl_dev

        if self.algorithm == "tpu":
            return self._chunked(wgl_dev, history, deadline, self.kernel_opts)
        if self.algorithm == "competition":
            return self._competition(history, wgl_dev, deadline)
        raise ValueError(f"unknown linearizability algorithm {self.algorithm!r}")

    def _chunked(self, wgl_dev, history, deadline, kernel_opts) -> dict:
        """``wgl.analysis`` on the checker's device under the deadline."""
        return wgl_dev.analysis(self.model, history, deadline=deadline,
                                device=self.device, **kernel_opts)

    def _competition(self, history, wgl_dev, deadline=None):
        """Fast engines first, exact ones on demand (see module doc).

        Tunables ride ``kernel-opts``: ``async-capacity`` sizes the beam
        ladder (the chunked engine's own ``capacity`` escalation ladder
        is a separate knob, forwarded untouched), ``confirm-max-configs``
        bounds the refutation-confirmation sweep, ``greedy-first: False``
        skips rung 0."""
        path: list[dict] = []  # the decision-path trail (obs.provenance)

        def _fin(res, engine_name):
            return _prov.attach(res, path, engine={"engine": engine_name})

        if deadline is not None and deadline.expired():
            # the budget was spent before this key's check began (e.g. by
            # earlier keys of an independent checker): degrade attributably
            path.append({"event": "fault.deadline", "at": "pre-check"})
            return _fin({
                "valid?": UNKNOWN,
                "cause": "deadline-exceeded: check budget exhausted",
            }, "competition")
        ladder = self.kernel_opts.get("async-capacity", (256, 1024))
        if isinstance(ladder, int):
            ladder = (ladder,)
        confirm_cap = self.kernel_opts.get("confirm-max-configs", 2_000_000)
        # Rung 0: the greedy witness walk — one config, no frontier
        # buffers, resolves most valid histories in one scan.
        if self.kernel_opts.get("greedy-first", True):
            g = wgl_dev.greedy_analysis(self.model, history, device=self.device)
            if g["valid?"] is True:
                path.append({"event": "engine.greedy", "outcome": "valid"})
                return _fin(g, "greedy")
            if "not tensorizable" in str(g.get("cause", "")):
                path.append({"event": "engine.greedy",
                             "outcome": "not-tensorizable"})
                path.append({"event": "cpu-fallback", "engine": "dfs"})
                return _fin(wgl_cpu.analysis(self.model, history), "wgl-dfs")
            path.append({"event": "engine.greedy", "outcome": "stuck"})
        for cap in ladder:
            a = wgl_dev.analysis_async(self.model, history, capacity=int(cap),
                                       device=self.device)
            path.append({"event": "async.capacity", "capacity": int(cap),
                         "outcome": _prov.verdict_str(a["valid?"])})
            if a["valid?"] is True:
                return _fin(a, "async")
            if a["valid?"] is False:
                # fast-engine kills are hash-decided: confirm on the
                # exact sweep, bounded to the failure prefix.  The bound
                # is the positional op id from the kernel stats (the
                # op's "index" field can differ from its position on
                # user-supplied histories).
                stop = a.get("kernel", {}).get("bar-opid")
                c = wgl_cpu.sweep_analysis(
                    self.model, history, max_configs=confirm_cap, stop_at_index=stop
                )
                path.append({"event": "confirm.sweep",
                             "outcome": _prov.verdict_str(c["valid?"])})
                if c["valid?"] is False:
                    return _fin({**a, "confirmed?": True}, "async")
                if c["valid?"] is True:
                    # hash-collision artifact: the sweep wins
                    return _fin(c, "wgl-sweep")
                break  # inconclusive: escalate to the oracles
            if "not tensorizable" in str(a.get("cause", "")):
                # no tensor form: every device rung would fail the same
                # way — the CPU oracle is the only engine
                path.append({"event": "cpu-fallback", "engine": "dfs"})
                return _fin(wgl_cpu.analysis(self.model, history), "wgl-dfs")
        if deadline is not None and deadline.expired():
            # past the budget the expensive oracles degrade to an
            # attributable unknown instead of running unbounded
            path.append({"event": "fault.deadline", "at": "pre-oracle"})
            return _fin({
                "valid?": UNKNOWN,
                "cause": "deadline-exceeded: check budget exhausted before "
                         "the exact oracles",
            }, "competition")
        dfs = wgl_cpu.analysis(self.model, history)
        path.append({"event": "engine.dfs",
                     "outcome": _prov.verdict_str(dfs["valid?"])})
        if dfs["valid?"] != UNKNOWN:
            return _fin(dfs, "wgl-dfs")
        # the exact device engine: final refutations, quantified prefix;
        # uses its own (chunked) capacity ladder from kernel_opts
        opts = {k: v for k, v in self.kernel_opts.items()
                if k not in ("async-capacity", "confirm-max-configs")}
        path.append({"event": "route.chunked-exact"})
        a = self._chunked(wgl_dev, history, deadline, opts)
        if a["valid?"] == UNKNOWN and "not tensorizable" in str(a.get("cause", "")):
            # keep the DFS's informative unknown (budget + op)
            return _fin(dfs, "wgl-dfs")
        return _fin(a, "chunked-exact")

    @staticmethod
    def _truncate(a: Mapping) -> dict:
        out = dict(a)
        if "final-paths" in out:
            out["final-paths"] = list(out["final-paths"])[:10]
        if "configs" in out:
            out["configs"] = list(out["configs"])[:10]
        return out

    def check(self, test, history, opts):
        out = self._truncate(
            self._analyze(history, deadline=(opts or {}).get("deadline"))
        )
        if out.get("valid?") is False:
            self._render_failure(test, history, out, opts)
        _prov.emit(test, history, out, source="check", model=self.model,
                   checker="linearizable", opts=opts)
        return out

    @staticmethod
    def _render_failure(test, history, result, opts):
        """Write linear.svg next to the results — the reference renders
        the failed linearization via knossos.linear.report
        (checker.clj:207-210)."""
        from jepsen_tpu_torch import store
        from jepsen_tpu_torch.checker.linear_svg import render_failure

        if not (test.get("name") and test.get("start-time-str")):
            return  # no store configured (bare checker unit tests)
        svg = render_failure(history, result.get("op"), result.get("cause", ""))
        try:
            d = store.test_dir(test)
            sub = (opts or {}).get("subdirectory")
            d = d / sub if sub else d
            d.mkdir(parents=True, exist_ok=True)
            (d / "linear.svg").write_text(svg)
            result["svg"] = str(d / "linear.svg")
        except OSError:
            pass  # store dir not writable

    def check_batch(self, test, histories, opts):
        """Check many subhistories in one batched ladder
        (``parallel.batch_analysis``; used by independent.checker:
        per-key shards become the batch's lanes), under the opts'
        deadline, checkpoint directory and ``"resume?"``.  CPU algorithms
        just loop, headless (independent.checker writes per-key
        artifacts).  Each result's evidence bundle is emitted."""
        if self.algorithm in ("wgl", "sweep"):
            outs = [self._truncate(self._analyze(hh)) for hh in histories]
            for hh, out in zip(histories, outs):
                _prov.emit(test, hh, out, source="check_batch",
                           model=self.model, checker="linearizable",
                           opts=opts)
            return outs
        from jepsen_tpu_torch.parallel.batch import batch_analysis

        # kernel-opts is shaped for wgl.analysis; forward only the keys
        # batch_analysis shares (capacity ladder, rounds, mesh, exact
        # stages, engine).
        kw = {
            k: v
            for k, v in self.kernel_opts.items()
            if k in ("capacity", "rounds", "mesh", "exact_escalation", "engine")
        }
        opts = opts or {}
        results = batch_analysis(
            self.model,
            histories,
            cpu_fallback=(self.algorithm == "competition"),
            deadline=opts.get("deadline"),
            checkpoint_dir=opts.get("checkpoint-dir"),
            resume=bool(opts.get("resume?")),
            device=self.device,
            **kw,
        )
        outs = [self._truncate(r) for r in results]
        for hh, out in zip(histories, outs):
            _prov.emit(test, hh, out, source="check_batch",
                       model=self.model, checker="linearizable", opts=opts)
        return outs


def linearizable(opts: Mapping) -> Checker:
    return Linearizable(opts)
