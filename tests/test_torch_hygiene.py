"""Import hygiene and entry-point contracts of the PyTorch port.

The port imports torch, never jax, and nothing of the JAX package; its
confirmation workers import no torch either.  Entry points run on the
card unless the caller asks for the CPU, and a kernel wrapper given a
tensor that is not on the CPU never falls back to its plain version.
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import _platform
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.ops import closure as tcl
from jepsen_tpu_torch.ops import wide_kernel as twk
from jepsen_tpu_torch.parallel import batch as tbatch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several worker processes share the host: one torch thread each
    for the module, so that no worker's torch pool oversubscribes the
    cores the others' tests (wall-clock floors among them) run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "jepsen_tpu_torch"


def _port_modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name.startswith("jaxlib")
            or name == "jepsen_tpu" or name.startswith("jepsen_tpu."))


def test_importing_every_port_module_loads_no_jax():
    """In a fresh interpreter, import the package and each of its
    modules: no jax* and no jepsen_tpu / jepsen_tpu.* entry may appear in
    sys.modules."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {json.dumps(_port_modules())}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("jepsen_tpu_torch.parallel.batch", "jepsen_tpu_torch.ops.closure",
                "jepsen_tpu_torch.checker.elle", "jepsen_tpu_torch.checker.txn_columns",
                "jepsen_tpu_torch.testing.gentxn"):
        assert mod in loaded
    bad = [k for k in loaded if _forbidden(k)]
    assert bad == []


def test_confirm_worker_import_chain_is_torch_free():
    """The modules a spawned confirmation worker imports load neither
    torch nor jax (a worker must never initialise CUDA)."""
    code = (
        "import json, sys\n"
        "import jepsen_tpu_torch, jepsen_tpu_torch._confirm_worker\n"
        "import jepsen_tpu_torch.checker.wgl_cpu, jepsen_tpu_torch.models\n"
        "import jepsen_tpu_torch.history\n"
        "print(json.dumps([k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'jax', 'jepsen_tpu')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_serve_policy_modules_import_without_torch():
    """The check service's policy modules (``serve.slo``,
    ``serve.sched.admission``, ``serve.health``) load neither torch nor
    jax nor the JAX package: an operator's tooling may read their
    journals and SLO specs on a host without torch."""
    code = (
        "import json, sys\n"
        "import jepsen_tpu_torch.serve.slo\n"
        "import jepsen_tpu_torch.serve.sched.admission\n"
        "import jepsen_tpu_torch.serve.health\n"
        "print(json.dumps([k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'jepsen_tpu')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
def test_static_scan_no_jax_imports(path):
    """No file of the package, nor chip_smoke.py, imports jax or the JAX
    package (checked on the syntax tree, so lazy imports count too)."""
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []


def test_resolve_device(monkeypatch):
    assert _platform.resolve_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _platform.resolve_device()
    with pytest.raises(RuntimeError):
        _platform.resolve_device("cuda")


def test_wrappers_never_fall_back_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses what it cannot launch: the plain version is never taken.
    The closure's entry points compute on the device they resolve (the
    card unless "cpu" is asked for), or raise: never on the CPU in its
    place."""
    n = 512
    st = torch.zeros(1, n, dtype=torch.int32, device="meta")
    fo = torch.zeros(1, n, 1, dtype=torch.int32, device="meta")
    fc = torch.zeros(1, n, 2, dtype=torch.int16, device="meta")
    al = torch.ones(1, n, dtype=torch.bool, device="meta")
    before = (twk.KEEP_LAUNCHES, twk.FUSED_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        twk.keep_mask(st, fo, fc, al)
    with pytest.raises(ValueError, match="CUDA"):
        twk.fused_frontier_update(st, fo, fc, al, None, 64, max_count=4)
    assert (twk.KEEP_LAUNCHES, twk.FUSED_LAUNCHES) == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcl.reset_counts()
    for call in _closure_calls():
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call(device)
        with pytest.raises(ValueError, match="unsupported device"):
            call("meta")
    assert tcl.BUCKET_LAUNCHES == {}


def _closure_calls():
    """Each entry point of ops.closure, as a function of its device."""
    from jepsen_tpu_torch.parallel.mesh import make_mesh

    adj = np.eye(4, k=1, dtype=bool)
    g = (adj, adj, adj, adj)
    m = tcl.pad_adj(adj, 128)
    return [
        lambda d: tcl.transitive_closure(m, 2, device=d),
        lambda d: tcl.classify_cycles(m, m, m, m, 2, device=d),
        lambda d: tcl.classify_cycles_hints(m, m, m, m, 2, device=d),
        lambda d: tcl.classify_cycles_batch(m[None], m[None], m[None], m[None], 2,
                                            device=d),
        lambda d: tcl.classify_graph(*g, device=d),
        lambda d: tcl.classify_graphs([g], device=d),
        lambda d: tcl.transitive_closure_sharded(adj, make_mesh(4, device=d)),
    ]


def test_closure_entry_points_run_where_asked():
    """With ``device="cpu"`` every closure entry point runs on the CPU:
    the oracle's closure of a path graph, and no cycle flagged on it."""
    want = tcl.transitive_closure_np(np.eye(4, k=1, dtype=bool))
    outs = [call("cpu") for call in _closure_calls()]
    np.testing.assert_array_equal(outs[0].numpy()[:4, :4] > 0, want)
    np.testing.assert_array_equal(outs[-1], want)
    assert outs[4] == (tcl._EMPTY_FLAGS, tcl._EMPTY_HINTS)
    assert outs[5] == [outs[4]]
    assert not bool(outs[1].g0) and not bool(outs[2].g2)


def test_batch_analysis_refuses_unported_options(tmp_path):
    """What the ladder does not run raises: a mesh that is not the
    port's ``Mesh`` (the cross-card mesh, queue B), an unknown engine
    and an unknown confirmation mode.  Checkpoints, deadlines, rung
    admission, device confirmation and a frontier budget run (an empty
    list of histories decides at once); the "sync" engine and exact
    stages run too."""
    model = tm.CASRegister(None)
    with pytest.raises(NotImplementedError, match="queue B"):
        tbatch.batch_analysis(model, [], device="cpu", mesh=object())

    class NoJoiners:
        def poll(self, stage, lanes):
            return []

    for kw in (dict(checkpoint_dir=tmp_path), dict(deadline=5.0),
               dict(admission=NoJoiners()), dict(confirm_refutations="device"),
               dict(frontier_budget_mb=30.0),
               dict(checkpoint_dir=tmp_path, resume=True),
               dict(engine="sync", exact_escalation=(64,))):
        assert tbatch.batch_analysis(model, [], device="cpu", **kw) == []
    with pytest.raises(ValueError, match="engine"):
        tbatch.batch_analysis(model, [], device="cpu", engine="bogus")
    with pytest.raises(ValueError, match="confirm_refutations"):
        tbatch.batch_analysis(model, [], device="cpu",
                              confirm_refutations="sometimes")


def test_spawned_confirm_worker_stays_off_torch():
    """A spawned confirmation worker, after a confirmation task, has
    imported neither torch nor jax."""
    from jepsen_tpu_torch.testing.genhist import valid_register_history

    pool = tbatch.confirm_pool(2)
    hist = valid_register_history(12, 2, seed=1)
    fut = pool.submit(tbatch._confirm_worker.confirm_refutation,
                      tm.CASRegister(None), hist, 10_000, None)
    assert fut.result(timeout=120)["valid?"] is True
    probe = pool.submit(tbatch._confirm_worker.probe).result(timeout=120)
    assert not probe["torch_loaded"] and not probe["jax_loaded"]
    assert "jepsen_tpu_torch.checker.wgl_cpu" in probe["modules"]


OBS_MODULES = sorted(
    str(p.relative_to(ROOT)) for p in (PKG / "obs").rglob("*.py"))


#: ``obs`` modules whose functions reach torch, and only inside a
#: function: the profiler hook when a capture starts, the regression
#: ledger's fingerprint and competition runner.
OBS_LAZY_TORCH = {"jepsen_tpu_torch/obs/profiler.py",
                  "jepsen_tpu_torch/obs/regress.py"}


def _imported(nodes):
    names = []
    for node in nodes:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def _module_level(tree):
    """The nodes of ``tree`` outside every function body."""
    out, todo = [], list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        out.append(node)
        todo.extend(ast.iter_child_nodes(node))
    return out


@pytest.mark.parametrize("path", OBS_MODULES)
def test_obs_modules_import_no_torch_jax_or_jepsen_tpu(path):
    """The telemetry package is stdlib only: no module of ``obs`` imports
    torch, jax or the JAX package (on the syntax tree, lazy imports
    included), but for torch inside the functions of
    ``OBS_LAZY_TORCH``."""
    tree = ast.parse((ROOT / path).read_text())
    names = _imported(ast.walk(tree))
    assert [n for n in names if _forbidden(n) or n.split(".")[0] == "numpy"] == []
    if path not in OBS_LAZY_TORCH:
        assert [n for n in names if n.split(".")[0] == "torch"] == []
    assert [n for n in _imported(_module_level(tree))
            if n.split(".")[0] == "torch"] == []


def test_store_web_and_perf_modules_import_without_torch(tmp_path):
    """In a fresh interpreter ``store.format``, ``native``, ``obs.regress``,
    ``obs.fleetview``, ``obs.profiler`` and ``web`` load no torch, no jax
    and nothing of the JAX package; nor does browsing a store through
    ``web``, writing and reading a run through ``store``, reading a
    ledger, or mounting a profiler hook (until a capture starts)."""
    code = (
        "import json, sys\n"
        "import jepsen_tpu_torch.store.format, jepsen_tpu_torch.native\n"
        "import jepsen_tpu_torch.obs.regress, jepsen_tpu_torch.obs.fleetview\n"
        "import jepsen_tpu_torch.obs.profiler, jepsen_tpu_torch.web as web\n"
        "from jepsen_tpu_torch import store\n"
        "from jepsen_tpu_torch.obs import profiler, regress\n"
        f"d = {str(tmp_path)!r}\n"
        "t = {'name': 'n', 'start-time-str': 't', 'store-dir': d,\n"
        "     'history': [{'type': 'ok', 'process': 0, 'f': 'read',\n"
        "                  'value': 1, 'index': 0, 'time': 0}],\n"
        "     'results': {'valid?': True}}\n"
        "store.save_0(t); store.save_1(t); store.save_2(t)\n"
        "assert store.load('n', 't', store_dir=d)['results']['valid?']\n"
        "assert 'n' in web.home_html(d) and web.suite_html(d)\n"
        "assert web.perf_html(d) and regress.read_records(store_dir=d) == []\n"
        "assert profiler.ProfilerHook(d).status()['profiling'] is False\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'jepsen_tpu'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_services_and_telemetry_import_without_torch():
    """In a fresh interpreter, every ``obs`` module, ``faults``,
    ``store.durable``, ``store.checkpoint`` and ``checker.wgl_cpu``
    (which now import ``obs``) load no torch, no jax and nothing of
    the JAX package, and recording a span, a counter and a gauge with
    them needs none either."""
    mods = [".".join(pathlib.Path(p).with_suffix("").parts).replace(
        ".__init__", "") for p in OBS_MODULES]
    code = (
        "import importlib, json, sys, tempfile\n"
        f"for m in {json.dumps(mods)} + ['jepsen_tpu_torch.faults',\n"
        "        'jepsen_tpu_torch.store.durable',\n"
        "        'jepsen_tpu_torch.store.checkpoint',\n"
        "        'jepsen_tpu_torch.checker.wgl_cpu']:\n"
        "    importlib.import_module(m)\n"
        "from jepsen_tpu_torch import obs\n"
        "with obs.recording(tempfile.mkdtemp()) as r:\n"
        "    with obs.span('s'):\n"
        "        obs.counter('c')\n"
        "        obs.gauge('g', 1)\n"
        "assert r.summary['counters'] == {'c': 1}\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'jepsen_tpu'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_unrecorded_ladder_writes_no_telemetry(tmp_path, monkeypatch):
    """With no recording open an entry point writes no telemetry file
    and takes the no-op path: no Recorder is ever built."""
    from jepsen_tpu_torch import obs
    from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history

    built = []
    monkeypatch.setattr(obs.Recorder, "__init__",
                        lambda self, d: built.append(d))
    monkeypatch.chdir(tmp_path)
    hists = [valid_register_history(16, 3, seed=1),
             corrupt(valid_register_history(16, 3, seed=2), seed=2)]
    res = tbatch.batch_analysis(tm.CASRegister(None), hists, capacity=(16,),
                                device="cpu", confirm_refutations=False,
                                checkpoint_dir=tmp_path / "ck")
    assert [r["valid?"] for r in res][0] is True
    assert built == [] and obs.active() is None
    assert not list(tmp_path.rglob("telemetry*"))
