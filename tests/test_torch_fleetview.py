"""The fleet metrics view (``obs.fleetview``) in the port against the
JAX package.

Every input of tests/test_fleetview.py that reaches ``fleetview``
without a live fleet router (the router is not ported yet) goes through
both packages, and the outputs are compared at tolerance 0: the
federated exposition text, the parsed expositions, the
``FederatedRegistry``'s reads, the fleet SLO's rows and alert
documents, and the merged Perfetto document of clock-aligned recorder
streams.  Each package's registries render the same text, so each
package's federation also reads the other's scrapes.
"""

import copy

import pytest

from jepsen_tpu.obs import fleetview as jfv
from jepsen_tpu.obs import metrics as jmet
from jepsen_tpu_torch.obs import fleetview as tfv
from jepsen_tpu_torch.obs import metrics as tmet

PKG = {"jax": (jfv, jmet), "port": (tfv, tmet)}


def _registry_pair(met):
    r0, r1 = met.Registry(), met.Registry()
    for r, count, depth, lat in ((r0, 3, 2, 0.1), (r1, 5, 4, 0.2)):
        r.inc("serve.requests", count)
        r.set("serve.queue_depth", depth)
        r.set("device.buffer_bytes", depth * 1024, device="0")
        for _ in range(count):
            r.observe("serve.request_latency_seconds", lat)
    return r0, r1


def _scrapes(met):
    r0, r1 = _registry_pair(met)
    return {"w0": r0.render(), "w1": r1.render()}


def _base(met):
    base = met.Registry()
    base.inc("fleet.routed", 7)
    base.inc("serve.requests", 2)
    return base


@pytest.mark.parametrize("errors", [None, {"w9": "connection refused"}])
def test_federate_is_equal(errors):
    out = {}
    for name, (fv, met) in PKG.items():
        fed = fv.federate(_base(met).render(), _scrapes(met), errors=errors)
        out[name] = (fed, fv.parse_exposition(fed))
    assert out["port"] == out["jax"]
    assert 'jepsen_tpu_fleet_serve_requests_total 8' in out["port"][0]


def test_each_package_federates_the_others_scrapes():
    for reader, writer in (("port", "jax"), ("jax", "port")):
        fv, _ = PKG[reader]
        _, wmet = PKG[writer]
        got = fv.federate(_base(wmet).render(), _scrapes(wmet))
        want = PKG[writer][0].federate(_base(wmet).render(), _scrapes(wmet))
        assert got == want


def test_parse_exposition_edge_lines():
    text = ("# HELP x help text\n# TYPE x counter\nx_total 1\n"
            'y{a="b\\"c",d="e\\\\f"} 2.5\nz NaN\nw +Inf\n\nbroken line\n')
    # repr: a NaN sample is equal to itself only as text
    assert repr(tfv.parse_exposition(text)) == repr(jfv.parse_exposition(text))


def test_federated_registry_reads_are_equal():
    out = {}
    for name, (fv, met) in PKG.items():
        base = _base(met)
        freg = fv.FederatedRegistry(base=base)
        freg.update(_scrapes(met))
        base.set("serve.queue_depth", 0)
        out[name] = (freg.get("serve.requests"),
                     freg.get("serve.queue_depth"),
                     freg.get("absent"),
                     freg.histogram_buckets("serve.request_latency_seconds"),
                     freg.histogram_buckets("absent"))
    assert out["port"] == out["jax"]
    assert out["port"][0] == 10.0


_SPEC = [{"name": "fleet-p75", "kind": "latency",
          "metric": "serve.request_latency_seconds",
          "threshold_s": 2.5, "target": 0.75}]


def _latency_scrape(met, n, seconds):
    r = met.Registry()
    for _ in range(n):
        r.observe("serve.request_latency_seconds", seconds)
    return r.render()


def test_fleet_slo_rows_and_alerts_are_equal():
    """One replica's brownout fires the fleet alert in both packages,
    with equal rows and alert documents (clock stamps dropped)."""
    out = {}
    for name, (fv, met) in PKG.items():
        fslo = fv.FleetSlo(copy.deepcopy(_SPEC))
        rows = fslo.evaluate({"w0": _latency_scrape(met, 20, 0.1),
                              "w1": _latency_scrape(met, 20, 4.0)}, now=100.0)
        alerts = fslo.alerts()
        out[name] = (rows, {k: v for k, v in alerts.items()
                            if k not in ("ts", "evaluated_at")})
    assert out["port"] == out["jax"]
    row = next(r for r in out["port"][0] if r["slo"] == "fleet-p75")
    assert row["state"] == "firing"


def _two_streams():
    router = [
        {"type": "meta", "version": 1, "wall-clock": 1000.0, "t0": 1000.0,
         "pid": 11, "host": "rt"},
        {"type": "span", "name": "fleet.route", "t": 0.5, "dur": 0.001,
         "trace": "T1", "attrs": {"replica": "w0"}},
    ]
    replica = [
        {"type": "meta", "version": 1, "wall-clock": 1000.2, "t0": 1000.2,
         "pid": 12, "host": "rep"},
        {"type": "span", "name": "serve.request", "t": 0.35, "dur": 0.1,
         "trace": "T1", "attrs": {"tier": "batch", "verdict": "true"}},
        {"type": "span", "name": "ladder.launch", "t": 0.36, "dur": 0.05,
         "attrs": {"devices": [0], "engine": "async"}},
        {"type": "gauge", "name": "serve.queue_depth", "t": 0.37, "value": 2},
    ]
    no_t0 = [{"type": "span", "name": "x", "t": 0.1, "dur": 0.1}]
    return [("router", router, 0), ("rep-w0", replica, 1),
            ("lost", no_t0)]


def test_merge_trace_events_is_equal():
    got = {name: fv.merge_trace_events(copy.deepcopy(_two_streams()))
           for name, (fv, _met) in PKG.items()}
    assert got["port"] == got["jax"]
    od = got["port"]["otherData"]
    assert [p["label"] for p in od["processes"]] == ["router", "rep-w0", "lost"]
    assert od["cross_process_traces"] == ["T1"]
