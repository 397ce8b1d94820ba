"""The port's chaos hook (``mqtt_tpu_torch.hooks.chaos``) held against the
JAX package's on the CPU.

A port ``Server(device="cpu", device_matcher=True)`` and a JAX server, each
with the matcher's breaker and its own package's ``ChaosHook`` armed from
one seeded plan, run one script: wildcard subscribers, QoS 1 publishes one
batch each (every send settles, so dispatch ``i`` is publish ``i`` in both
packages), a churn folded between batches, each fault kind pinned at least
once, then three errors in a row that trip the breaker. The hook is then
uninstalled, two forced probes close the breaker, and a last round runs on
the device. Every client's bytes equal the JAX server's, and so do the
breaker's gauges and failure kinds and the injector's counts. The probe
delay is past the run, so no probe on the wall clock enters the
comparison. The port's matcher takes the compact route, and no batch
still pins a table buffer once the hook is gone.
"""

import asyncio
import time
from importlib import import_module

import pytest

from chip_smoke import publish_frame, subscribe_frame, unsubscribe_frame
from test_torch_server import BREAKER_GAUGES, Broker, allow, package, pinned_clock  # noqa: F401

# the fault kind at each injector dispatch: one publish a batch
AT = {1: "error", 3: "issue_error", 5: "corrupt", 7: "slow", 9: "hang", 12: "error", 13: "error", 14: "error"}
SUBSCRIBERS = 8
ROUNDS = 16  # publishes before the trip's last dispatch (14), and one after it


def chaos_options(chaos, seed: int = 5):
    return chaos.ChaosOptions(seed=seed, hang_s=30.0, slow_s=0.05, at=dict(AT))


async def script(b: Broker) -> None:
    for i in range(SUBSCRIBERS):
        await b.connect(f"s{i}", 4 + i % 2)
        await b.send(f"s{i}", subscribe_frame(1, [(f"chaos/+/{i % 4}", 1, 0), (f"alt/{i % 4}/#", 1, 0)],
                                              4 + i % 2))
    await b.connect("p", 4)
    b.fold()
    for r in range(ROUNDS):
        topic = f"chaos/r{r}/{r % 4}" if r % 2 else f"alt/{r % 4}/r{r}"
        await b.send("p", publish_frame(topic, b"m%d" % r, 1, r + 1))
        # a churn between batches, folded onto the device table
        s = f"s{r % SUBSCRIBERS}"
        await b.send(s, unsubscribe_frame(100 + r, [f"alt/{r % 4}/#"], 4 + (r % SUBSCRIBERS) % 2))
        await b.send(s, subscribe_frame(200 + r, [(f"alt/{r % 4}/#", 1, 0)], 4 + (r % SUBSCRIBERS) % 2))
        b.fold()
    rm = b.srv.matcher
    b.tripped = rm.breaker.state
    b.hook.uninstall()
    deadline = time.monotonic() + 30
    while rm.pool.wedged and time.monotonic() < deadline:  # the released hang's guard thread retires
        await asyncio.sleep(0.01)
    b.probes = [rm.probe_now(), rm.probe_now()]
    for r in range(ROUNDS, ROUNDS + 4):
        await b.send("p", publish_frame(f"chaos/r{r}/{r % 4}", b"m%d" % r, 1, r + 1))
    b.gauges = rm.breaker_gauges()
    b.injected = b.hook.injected
    b.dm = rm.inner


def run_chaos(name: str):
    pkg = package(name)
    chaos = import_module(pkg.hooks.__name__ + ".chaos")

    async def main():
        hook, opts = chaos.ChaosHook(), chaos_options(chaos)
        b = Broker(pkg, hooks=allow(pkg) + [(hook, opts)], matcher_resilience=True, breaker_watchdog_ms=2000.0,
                   breaker_probe_backoff_ms=3_600_000.0, breaker_probe_backoff_max_ms=3_600_000.0)
        opts.server = b.srv  # the hook installs itself at on_started
        b.hook = hook
        await b.start()
        b.installed = hook.faulty is not None and b.srv.matcher.inner is hook.faulty
        b.injected_all = hook.faulty.injected
        await script(b)
        return await b.close(), b

    return asyncio.run(main())


def test_chaos_under_one_seed_equals_the_jax_server(pinned_clock):
    (jout, jb), (tout, tb) = run_chaos("jax"), run_chaos("torch")
    assert list(tout) == list(jout)
    for name in jout:
        assert tout[name] == jout[name], name
    assert tb.installed and jb.installed
    assert tb.injected_all == jb.injected_all == {
        "error": 4, "issue_error": 1, "corrupt": 1, "slow": 1, "hang": 1}
    assert tb.tripped == jb.tripped == "open" and tb.probes == jb.probes == [True, True]
    jg, tg = jb.gauges, tb.gauges
    assert {k: tg[k] for k in BREAKER_GAUGES} == {k: jg[k] for k in BREAKER_GAUGES}
    kinds = {k: v for k, v in tg.items() if k.startswith("failures_")}
    assert kinds == {k: v for k, v in jg.items() if k.startswith("failures_")}
    # the breaker's counts by kind are the injector's: an issue failure
    # reads as an error
    assert kinds == {"failures_error": 5, "failures_corrupt": 1, "failures_hang": 1}
    assert tg["state"] == "closed" and tg["trips"] == 1 and tg["probes"] == 2
    # every publish reached its two subscribers, the faulted ones from the walk
    delivered = sum(c.count(b"m") for conns in tout.values() for c in conns)
    assert delivered >= 2 * (ROUNDS + 4)
    # the port's batches took the compact route, and none still pins a buffer
    snap = tb.dm.snapshot
    assert snap.stats.compact_batches > 0 and snap.stats.folds > 0
    assert all(buf.pins == 0 for buf in snap._tables)


def test_uninstall_restores_the_matcher_without_the_breaker(pinned_clock):
    """With the breaker off the hook wraps ``Server.matcher`` and the
    stage's captured reference, and uninstall puts both back."""
    pkg = package("torch")
    from mqtt_tpu_torch.hooks.chaos import ChaosHook, ChaosOptions

    async def main():
        hook, opts = ChaosHook(), ChaosOptions(seed=1, at={0: "slow"}, slow_s=0.01)
        b = Broker(pkg, hooks=allow(pkg) + [(hook, opts)])
        opts.server = b.srv
        await b.start()
        inner = hook.faulty.inner
        wrapped = b.srv.matcher is hook.faulty and b.srv._stage.matcher is hook.faulty
        await b.connect("s", 4)
        await b.send("s", subscribe_frame(1, [("a/+", 1, 0)]))
        await b.connect("p", 4)
        b.fold()
        await b.send("p", publish_frame("a/x", b"hi", 1, 1))
        injected = hook.injected
        await b.close()
        return wrapped, injected, hook.faulty, b.srv.matcher is inner, b.srv._stage is None or (
            b.srv._stage.matcher is inner)

    wrapped, injected, faulty, restored, stage_restored = asyncio.run(main())
    assert wrapped and injected == {"slow": 1}
    assert faulty is None and restored and stage_restored


def test_chaos_options_are_required_to_be_chaos_options():
    from mqtt_tpu_torch.hooks import ON_STARTED, ON_STOPPED
    from mqtt_tpu_torch.hooks.chaos import ChaosHook

    h = ChaosHook()
    with pytest.raises(ValueError, match="ChaosOptions"):
        h.init({"seed": 1})
    h.init(None)
    assert h.id() == "chaos" and h.provides(ON_STARTED) and h.provides(ON_STOPPED) and h.injected == {}
    h.on_started()  # no server: nothing to arm
    assert h.faulty is None
