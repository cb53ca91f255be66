"""The port's own copies of the JAX package's host-side modules (the
history generator, the CPU model classes and the exact sweep) against
the originals, on the same inputs.

The copies exist so that the port imports nothing of the JAX package;
these tests keep them from drifting.  Every comparison is exact.
"""

import pathlib
import random
import sys

import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.checker import wgl_cpu as jcpu
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import wgl_cpu as tcpu
from jepsen_tpu_torch.testing import genhist as tgen

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

import genhist as jgen  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several worker processes share the host: one torch thread each
    for the module, so that no worker's torch pool oversubscribes the
    cores the others' tests (wall-clock floors among them) run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", range(4))
def test_genhist_same_histories(seed):
    """valid_register_history and corrupt give the tools generator's
    histories for the same arguments (exact)."""
    for n_ops, procs, info, vals in ((30, 3, 0.05, 5), (100, 8, 0.3, 8)):
        want = jgen.valid_register_history(n_ops, procs, seed=seed,
                                           info_rate=info, n_values=vals)
        got = tgen.valid_register_history(n_ops, procs, seed=seed,
                                          info_rate=info, n_values=vals)
        assert got == want
        assert tgen.corrupt(got, seed=seed) == jgen.corrupt(want, seed=seed)


def _random_ops(name: str, rng: random.Random, n: int):
    vals = [0, 1, 2] if name.endswith("queue") else [None, 0, 1, 2]
    fs ={"register": ["read", "write"], "cas-register": ["read", "write", "cas"],
          "mutex": ["acquire", "release"], "unordered-queue": ["enqueue", "dequeue"],
          "fifo-queue": ["enqueue", "dequeue"], "counter": ["add", "read"]}[name]
    for _ in range(n):
        f = rng.choice(fs)
        if f == "cas":
            v = [rng.choice(vals), rng.choice(vals)]
        elif f == "add":
            v = rng.randrange(3)
        else:
            v = rng.choice(vals)
        yield {"f": f, "value": v}


@pytest.mark.parametrize("name", sorted(jm.REGISTRY))
def test_cpu_models_step_alike(name):
    """Every CPU model class steps through random op sequences to equal
    successors, and is inconsistent at the same ops (exact)."""
    assert set(tm.REGISTRY) == set(jm.REGISTRY)
    rng = random.Random(name)
    for _ in range(40):
        a, b = jm.model(name), tm.model(name)
        for op in _random_ops(name, rng, 12):
            a, b = a.step(op), b.step(op)
            assert jm.is_inconsistent(a) == tm.is_inconsistent(b)
            if tm.is_inconsistent(b):
                assert a.msg == b.msg
                break
            assert _fields(a) == _fields(b)


def _fields(x) -> tuple:
    return tuple(getattr(x, f) for f in x.__dataclass_fields__)


def _verdict(r: dict) -> tuple:
    return r["valid?"], r.get("op")


@pytest.mark.parametrize("seed", range(6))
def test_sweep_analysis_same_verdicts(seed):
    """The exact sweep: the same verdict and refuting op as the JAX
    package's, on valid and corrupted histories, bounded by
    stop_at_index, and under a budget small enough to give up (exact)."""
    model_j, model_t = jm.CASRegister(None), tm.CASRegister(None)
    hist = tgen.valid_register_history(40, 5, seed=seed, info_rate=0.3)
    for hh in (hist, tgen.corrupt(hist, seed=seed)):
        want = jcpu.sweep_analysis(model_j, hh)
        assert _verdict(tcpu.sweep_analysis(model_t, hh)) == _verdict(want)
        stop = len(hh) // 2
        assert (_verdict(tcpu.sweep_analysis(model_t, hh, stop_at_index=stop))
                == _verdict(jcpu.sweep_analysis(model_j, hh, stop_at_index=stop)))
        assert (tcpu.sweep_analysis(model_t, hh, max_configs=1)["valid?"]
                == jcpu.sweep_analysis(model_j, hh, max_configs=1)["valid?"])
