"""The port's public surface held against the JAX package's on the CPU:
the package's names, and the members that running the JAX suite over the
port found missing (``FlatIndex.wildcard_free``/``num_nodes``/``num_subs``,
``MatchStage.batch_cap``, ``Server.host_profile_block``), each equal to
the JAX member on the same inputs."""

import random

import pytest

import mqtt_tpu
import mqtt_tpu_torch
from mqtt_tpu.ops.flat import build_flat_index as jbuild
from mqtt_tpu.packets import Subscription as JSubscription
from mqtt_tpu.staging import MatchStage as JMatchStage
from mqtt_tpu.topics import Subscribers as JSubscribers
from mqtt_tpu.topics import TopicsIndex as JTopicsIndex

from mqtt_tpu_torch import MatchStage, Subscribers, Subscription, TopicsIndex
from mqtt_tpu_torch.ops.flat import build_flat_index as tbuild

from tests import test_torch_server as ts


def test_every_name_of_the_jax_package_is_the_ports():
    assert set(mqtt_tpu.__all__) <= set(mqtt_tpu_torch.__all__)
    for name in mqtt_tpu.__all__:
        assert getattr(mqtt_tpu_torch, name).__name__ == getattr(mqtt_tpu, name).__name__ if callable(
            getattr(mqtt_tpu, name)) else getattr(mqtt_tpu_torch, name) == getattr(mqtt_tpu, name), name
    assert mqtt_tpu_torch.__version__ == mqtt_tpu.__version__


def _twin_tries(seed: int, wildcards: bool):
    rng = random.Random(seed)
    j, t = JTopicsIndex(), TopicsIndex()
    for i in range(400):
        parts = [f"a{rng.randrange(6)}", f"b{rng.randrange(6)}", f"c{rng.randrange(6)}"]
        if wildcards and rng.random() < 0.2:
            parts[rng.randrange(3)] = "+"
        flt = "/".join(parts[: rng.randrange(1, 4)])
        j.subscribe(f"c{i % 50}", JSubscription(filter=flt, qos=i % 3))
        t.subscribe(f"c{i % 50}", Subscription(filter=flt, qos=i % 3))
    return j, t


@pytest.mark.parametrize("wildcards", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_flat_index_properties_equal_the_jax_ones(seed, wildcards):
    j, t = _twin_tries(seed, wildcards)
    jf, tf = jbuild(j, max_levels=4), tbuild(t, max_levels=4)
    got = (tf.wildcard_free, tf.num_nodes, tf.num_subs, tf.num_patterns)
    assert got == (jf.wildcard_free, jf.num_nodes, jf.num_subs, jf.num_patterns)
    assert tf.wildcard_free is not wildcards and tf.num_subs > 200


@pytest.mark.parametrize("kw", [{}, {"latency_budget_s": None}, {"max_batch": 512},
                                {"max_batch": 8192, "latency_budget_s": 0.05}])
def test_batch_cap_starts_where_the_jax_stages_does(kw):
    j = JMatchStage(None, lambda t: JSubscribers(), **kw)
    t = MatchStage(None, lambda t: Subscribers(), **kw)
    assert t.batch_cap == j.batch_cap
    for stage in (j, t):
        stage._batch_cap = 77
    assert t.batch_cap == j.batch_cap == 77


def test_host_profile_block_has_the_jax_servers_blocks():
    blocks = {}
    for name in ("jax", "torch"):
        pkg = ts.package(name)
        srv = pkg.server.Server(ts.options(pkg, planes=True))
        blocks[name] = srv.host_profile_block()
        bare = pkg.server.Server(ts.options(pkg))
        assert bare.host_profile_block() == {}
    jb, tb = blocks["jax"], blocks["torch"]
    assert sorted(tb) == sorted(jb) and {"profiler", "topics", "fanout"} <= set(tb)
    for k in tb:
        if isinstance(jb[k], dict):
            assert sorted(tb[k]) == sorted(jb[k]), k
    assert tb["fanout"] == jb["fanout"]
