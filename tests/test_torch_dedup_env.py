"""The dedup backend's environment variable in the port against the JAX
package.

Both packages resolve the backend as the explicit ``dedup_backend=``
argument, else ``JEPSEN_TPU_DEDUP_BACKEND``, else the module default;
the JAX name "pallas" in the variable is read by the port as "fused",
the port's name for the same route.  Each case runs ``batch_analysis``
in both packages at the suite's (30, 3) histories on capacity (64, 256)
(the port on the CPU) and reads the backend that each ladder stage row
(``ladder.stage``'s ``dedup``) and each result's evidence engine block
(``provenance.engine.dedup_backend``) name.
"""

import json

import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu import obs as jobs
from jepsen_tpu.ops import hashing as jhashing
from jepsen_tpu.parallel import batch as jb
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import obs as tobs
from jepsen_tpu_torch.ops import hashing as thashing
from jepsen_tpu_torch.parallel import batch as tb
from jepsen_tpu_torch.testing.genhist import corrupt, valid_register_history

CAP = (64, 256)
ENV = "JEPSEN_TPU_DEDUP_BACKEND"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hists():
    hists = [valid_register_history(30, 3, seed=i, info_rate=0.1)
             for i in range(3)]
    hists[2] = corrupt(hists[2], seed=2)
    return hists


def _run(pkg, tmp_path, **kw):
    """``(stage-row backends, evidence-block backends)`` of one ladder
    run in package ``pkg``."""
    obs, batch, m = ((jobs, jb, jm) if pkg == "jax" else (tobs, tb, tm))
    if pkg == "port":
        kw["device"] = "cpu"
    d = tmp_path / pkg
    with obs.recording(d):
        results = batch.batch_analysis(m.CASRegister(None), _hists(),
                                       capacity=CAP, **kw)
    stages = set()
    for line in (d / "telemetry.jsonl").read_text().splitlines():
        ev = json.loads(line)
        if ev.get("name") == "ladder.stage":
            stages.add(ev["attrs"]["dedup"])
    evidence = {r["provenance"]["engine"]["dedup_backend"] for r in results}
    return stages, evidence


def test_env_names_the_backend_in_both_packages(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV, "bucket")
    assert jhashing.resolve_dedup_backend() == "bucket"
    assert thashing.resolve_dedup_backend() == "bucket"
    want = ({"bucket"}, {"bucket"})
    assert _run("jax", tmp_path) == want
    assert _run("port", tmp_path) == want


def test_env_pallas_reads_as_fused_in_the_port(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV, "pallas")
    assert jhashing.resolve_dedup_backend() == "pallas"
    assert thashing.resolve_dedup_backend() == "fused"
    assert _run("port", tmp_path) == ({"fused"}, {"fused"})


def test_explicit_argument_wins_over_env(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV, "bucket")
    assert jhashing.resolve_dedup_backend("sort") == "sort"
    assert thashing.resolve_dedup_backend("sort") == "sort"
    want = ({"sort"}, {"sort"})
    assert _run("jax", tmp_path, dedup_backend="sort") == want
    assert _run("port", tmp_path, dedup_backend="sort") == want


def test_unset_env_keeps_each_default(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert jhashing.resolve_dedup_backend() == jhashing.DEDUP_BACKEND
    assert thashing.resolve_dedup_backend() == "fused"
    monkeypatch.setenv(ENV, "nope")
    with pytest.raises(ValueError):
        thashing.resolve_dedup_backend()
    with pytest.raises(ValueError):
        jhashing.resolve_dedup_backend()
