"""The port's host observatory (``mqtt_tpu_torch.profiling``) against the JAX
package's (``mqtt_tpu.profiling``), on the CPU.

- ``SamplingProfiler``: the same seeded stream of thread stacks, handed to
  a profiler of each package through its ``frames_fn`` seam and swept
  with ``sample_once(now=...)`` (no timer thread, no sleeps), gives
  byte-identical collapsed text, equal Chrome trace events (the wall
  anchor pinned), equal ``top_stacks`` and ``bench_block``; both
  packages' ``check_collapsed`` accept the text with the same count and
  refuse the same malformed lines.
- ``TopicSketch``: the same seeded topic stream (hot topics over a long
  tail, past the capacity) gives the same top-K, counts, errors,
  evictions and average hits.
- A port ``Server`` served on the CPU starts its profiler thread in
  ``serve()`` and stops it in ``close()``. Tolerance 0.
"""

import asyncio
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from mqtt_tpu import profiling as jprof

from mqtt_tpu_torch import profiling as tprof

FUNCS = ["_run", "serve", "read", "process_publish", "_fan_out", "match_topics", "wait", "select", "encode"]
FILES = ["/a/server.py", "/a/clients.py", "/b/staging.py", "/b/threading.py", "/c/odd;name.py"]


class _Code:
    """A stand-in code object: hashable by identity, as code objects are
    to the profiler's label memo."""

    def __init__(self, i: int) -> None:
        self.co_name = FUNCS[i % len(FUNCS)]
        self.co_filename = FILES[i % len(FILES)]


CODES = [_Code(i) for i in range(40)]


def _frames(rng) -> dict:
    """One sweep's ``sys._current_frames()``: four fake thread ids, each
    with a seeded stack of fake frames (root last, as ``f_back`` runs)."""
    out = {}
    for tid in (101, 202, 303, 404):
        if rng.random() < 0.15:
            continue  # the thread is gone this sweep
        depth = int(rng.integers(2, 9))
        f = None
        for d in range(depth):
            idx = int(rng.integers(0, 6)) + 6 * d if rng.random() < 0.8 else int(rng.integers(0, 40))
            f = SimpleNamespace(f_code=CODES[idx % 40], f_lineno=10 + d, f_back=f)
        out[tid] = f
    return out


def _sweeps(seed: int, n: int = 300) -> list:
    rng = np.random.default_rng(seed)
    return [_frames(rng) for _ in range(n)]


def _drive(mod, sweeps: list):
    it = iter(sweeps)
    prof = mod.SamplingProfiler(hz=29.0, ring=64, max_stacks=40, max_depth=6, frames_fn=lambda: next(it))
    prof._anchor = 0.0
    for k in range(len(sweeps)):
        prof.sample_once(now=50.0 + k / 29.0)
    return prof


@pytest.mark.parametrize("seed", [0, 2, 9])
def test_same_stacks_give_the_same_exports(seed):
    sweeps = _sweeps(seed)
    j, t = _drive(jprof, sweeps), _drive(tprof, sweeps)
    jtext, ttext = j.collapsed(), t.collapsed()
    assert ttext == jtext
    assert tprof.check_collapsed(ttext) == jprof.check_collapsed(jtext) > 10
    assert t.trace_events(pid=3) == j.trace_events(pid=3)
    assert t.top_stacks(7) == j.top_stacks(7)
    assert t.bench_block() == j.bench_block()
    assert t.dropped_stacks == j.dropped_stacks > 0  # the distinct-stack cap bound
    t.reset(), j.reset()
    assert t.samples == j.samples == 0 and t.collapsed() == j.collapsed() == ""


@pytest.mark.parametrize("text", ["", "main;a 0\n", "no-count\n", "main;;b 3\n", " lead 2\n", "x;y 5\nz 1\n"])
def test_check_collapsed_agrees(text):
    def verdict(mod):
        try:
            return mod.check_collapsed(text)
        except ValueError as e:
            return str(e)

    assert verdict(tprof) == verdict(jprof)


@pytest.mark.parametrize("seed", [1, 4])
def test_topic_sketch_gives_the_same_top_k(seed):
    rng = np.random.default_rng(seed)
    hot = [f"site/{i}/temp" for i in range(12)]
    stream = [hot[int(rng.integers(0, len(hot)))] if rng.random() < 0.6 else f"tail/{int(rng.integers(0, 5000))}"
              for _ in range(20000)]
    j, t = jprof.TopicSketch(k=64), tprof.TopicSketch(k=64)
    for topic in stream:
        n = 1 + int(topic.endswith("7/temp"))
        j.observe(topic, n)
        t.observe(topic, n)
    assert t.top(20) == j.top(20)
    assert t.bench_block(10) == j.bench_block(10)
    assert (t.tracked, t.min_count(), t.avg_hits_per_topic(), t.evictions) == (
        j.tracked, j.min_count(), j.avg_hits_per_topic(), j.evictions)
    assert t.evictions > 0 and {r["topic"] for r in t.top(12)} == set(hot)


def test_a_served_server_runs_its_profiler_until_close():
    from mqtt_tpu_torch.listeners import TCP, Config
    from mqtt_tpu_torch.server import Options, Server

    async def main():
        srv = Server(Options(device="cpu", gc_tuning=False, profile_hz=200.0))
        srv.add_listener(TCP(Config(type="tcp", id="t", address="127.0.0.1:0")))
        assert srv.host_profiler._thread is None  # built, not served: no thread
        await srv.serve()
        thread = srv.host_profiler._thread
        assert thread is not None and thread.is_alive() and thread.name == "mqtt-torch-profiler"
        for _ in range(200):
            if srv.host_profiler.samples >= 3:
                break
            await asyncio.sleep(0.01)
        assert srv.telemetry.lock_plane is not None and srv._lock_plane_armed
        await srv.close()
        assert srv.host_profiler._thread is None and not thread.is_alive() and not srv._lock_plane_armed
        return tprof.check_collapsed(srv.host_profiler.collapsed())

    assert asyncio.run(main()) > 0
    assert not any(t.name == "mqtt-torch-profiler" for t in threading.enumerate())
