"""The resilience benches of the port (``mxnet_tpu_torch/tools/bench_{elastic,
ckpt,lockwatch,controller}.py``) at ``--smoke --cpu``, each in a process of
its own, against what ``tests/test_bench_entry.py`` holds of the JAX
package's ``bench.py`` modes, and their deterministic fields against the
JAX package called in this process: the elastic world sequence, and the
controller's evicted and backfilled ranks on the bench's scripted
straggler and flaky rank.

Held on the card only (``tests/test_torch_bench_subsystems_card.py``,
``chip_smoke.py`` phase ``bench_subsystems``): the checkpoint stall under
10% of a synchronous save and below it, the watchdog's share under 2%, and
the goodput the controller wins back (timed shares and fractions, which on
a loaded build box measure the load).
"""

import types

import pytest

from mxnet_tpu import resilience as jres
from mxnet_tpu import telemetry as jtel
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.tools import (bench_ckpt, bench_controller,
                                   bench_elastic, bench_lockwatch)
from torch_bench_util import contract, run_benches  # noqa: F401

NAMES = ("elastic", "ckpt", "lockwatch", "controller")
PORT = types.SimpleNamespace(tel=ttel, R=tres)
JAX = types.SimpleNamespace(tel=jtel, R=jres)


@pytest.fixture(scope="module")
def bench(run_benches):  # noqa: F811
    return run_benches(*NAMES)


@pytest.fixture
def _fresh_hubs():
    prev = (ttel.current_rank(), ttel.world_size(), jtel.current_rank(),
            jtel.world_size())
    yield
    ttel.set_world(*prev[:2])
    jtel.set_world(*prev[2:])
    ttel.reset()
    jtel.reset()


def test_elastic_smoke_contract(bench):
    """``tests/test_bench_entry.py:226-242``: both resizes (8 -> 6 -> 8)
    with their downtime, a step time at every world, resize badput."""
    blob = bench("elastic")
    contract(blob, "elastic", "elastic_resize_downtime_seconds",
             ("value", "vs_baseline", "shrink_downtime_s", "grow_downtime_s",
              "resizes", "worlds", "step_ms_by_world",
              "goodput_pct_by_epoch", "resize_badput_s"))
    bench_elastic.check(blob)  # two resizes, worlds [6, 8]
    assert blob["shrink_downtime_s"] > 0
    assert blob["grow_downtime_s"] > 0
    assert blob["resize_badput_s"] > 0
    for world in ("8_pre", "6", "8_post"):
        assert blob["step_ms_by_world"].get(world, 0) > 0, blob


def _worlds(P):
    """The bench's membership script through a package's coordinator:
    two of eight killed, then every rank rejoined."""
    co = P.R.ElasticCoordinator(8)
    co.kill()
    co.kill()
    co.commit(co.poll())
    co.join_all()
    co.commit(co.poll())
    return [h["to"] for h in co.history]


def test_elastic_worlds_are_the_jax_coordinators(bench, _fresh_hubs):
    assert bench("elastic")["worlds"] == _worlds(PORT) == _worlds(JAX)


def test_ckpt_smoke_contract(bench):
    """``tests/test_bench_entry.py:256-281``: both recovery tiers (the peer
    tier live, then killed by chaos), badput at the three cadences,
    falling with the cadence."""
    blob = bench("ckpt")
    contract(blob, "ckpt", "ckpt_async_stall_pct_of_sync",
             ("value", "vs_baseline", "async_stall_ms", "sync_save_ms",
              "peer_recovery_s", "disk_recovery_s", "badput_by_cadence",
              "bounds"))
    assert blob["value"] > 0
    assert blob["async_stall_ms"] > 0 and blob["sync_save_ms"] > 0
    bench_ckpt.check(blob)  # tiers t1, then t2
    assert blob["peer_recovery_s"] > 0 and blob["disk_recovery_s"] > 0
    rows = blob["badput_by_cadence"]
    assert set(rows) == {"1", "4", "16"}
    assert all(r["badput_s_per_epoch"] >= 0 for r in rows.values())
    assert rows["16"]["badput_s_per_epoch"] <= rows["1"]["badput_s_per_epoch"]


def test_lockwatch_smoke_contract(bench):
    """``tests/test_bench_entry.py:331-351``: zero lock-order cycles in
    both soaks, no hung worker, both resizes under the watchdog."""
    blob = bench("lockwatch")
    contract(blob, "lockwatch", "lockwatch_overhead_pct_of_step",
             ("value", "vs_baseline", "pair_ns_off", "pair_ns_on",
              "pair_delta_ns", "acquires_per_step", "step_ms", "cycles",
              "max_hold_ms", "kv_soak", "resizes", "worlds", "bounds"))
    bench_lockwatch.check(blob)  # no cycle, no hang, worlds [3, 4]
    assert blob["kv_soak"]["hung"] is False, blob
    assert blob["value"] >= 0
    assert blob["pair_ns_on"] > blob["pair_ns_off"] > 0
    assert blob["acquires_per_step"] > 0 and blob["step_ms"] > 0
    assert blob["resizes"] == 2, blob


def test_controller_smoke_contract(bench):
    """``tests/test_bench_entry.py:296-312``: the straggler evicted, a tier
    picked, the breaker closed."""
    blob = bench("controller")
    contract(blob, "controller", "controller_goodput_recovered_frac",
             ("value", "vs_baseline", "tpc_clean", "tpc_static",
              "tpc_controller", "final_step_ms", "evicted", "backfilled",
              "tier_chosen", "retier_actions", "worlds", "breaker_state",
              "decisions_total"))
    bench_controller.check(blob)  # rank 7 evicted, the breaker closed
    assert blob["tier_chosen"] in ("bf16", "int8", "twobit")
    assert blob["worlds"][0] == 7


def _scripted(P, steps=60, stall_ms=50.0):
    """The bench's faults as a script through a package's controller, on a
    virtual clock: rank 7's spans carry the stall in every step it is in
    the world, rank 6 dies at step 30 and beats again (the coordinator
    readmits on the backfill lever). Returns the actuated levers with
    their ranks, and the worlds."""
    P.tel.reset()
    co = P.R.ElasticCoordinator(8)
    ctl = P.R.FleetController(**bench_controller.CONTROLLER)
    ctl.bind(coordinator=co, model_key="m", world_size=8, can_retier=True,
             fp32_wire_bytes=1e6)
    for s in range(steps):
        for r in co.alive:
            d = stall_ms + 2.0 if r == bench_controller.STRAGGLER else 2.0
            P.tel.emit("span", rank=r, name="step", epoch=0, step=s,
                       dur_ms=d, phases=[{"name": "device", "dur_ms": d}])
        if s == 30:
            co.kill(bench_controller.FLAKY, reason="failure")
        ctl.tick(now=s * 0.1)
        ev = co.poll()
        if ev is not None:
            co.commit(ev)
    acted = [(d["lever"], d.get("rank")) for d in ctl.decisions
             if d["outcome"] == "actuated"]
    return acted, [h["to"] for h in co.history]


def test_controller_ranks_are_the_jax_controllers(bench, _fresh_hubs):
    """The evicted and backfilled ranks of the bench's faults, scripted,
    are the JAX package's; the bench's own run evicts the same rank."""
    got = _scripted(PORT)
    assert got == _scripted(JAX)
    evicted = [r for lever, r in got[0] if lever == "evict"]
    backfilled = [r for lever, r in got[0] if lever == "backfill"]
    assert evicted == [bench_controller.STRAGGLER]
    assert backfilled == [bench_controller.FLAKY]
    assert bench("controller")["evicted"] == evicted
