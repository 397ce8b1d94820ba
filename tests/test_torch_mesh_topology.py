"""The port's spanning-tree topology (``mqtt_tpu_torch.mesh_topology``) held
against the JAX package's ``mqtt_tpu.mesh_topology`` on the CPU.

Every case of ``tests/test_mesh_topology.py`` runs again on the port
(``tests/torch_mirror.py``: the same bodies, seeds and assertions, the
imports answered by the port). Then both packages take the same seeded
inputs and must agree bit for bit: the elected parent maps, neighbours,
children and successors over random membership views and degrees; the
epoch order; whole adopt/propose protocol runs of a ``Topology``; the
counted bloom's wire bits and generations through adds and discards, the
plain ``BloomBits`` unions and probes; and the duplicate window's verdicts.
"""

import random

import pytest

from mqtt_tpu import mesh_topology as J
from mqtt_tpu_torch import mesh_topology as T
from tests import torch_mirror

torch_mirror.export(torch_mirror.mirror("tests.test_mesh_topology"), globals(), "Port")


def _views(seed: int):
    r = random.Random(seed)
    for _ in range(40):
        members = r.sample(range(300), r.randint(1, 80))
        yield members, r.randint(1, 7)


@pytest.mark.parametrize("seed", range(6))
def test_elections_and_edges_equal_the_jax_package(seed):
    for members, degree in _views(seed):
        jp, tp = J.compute_parents(members, degree), T.compute_parents(members, degree)
        assert tp == jp
        assert T.compute_successor(members) == J.compute_successor(members)
        for w in members[:8]:
            assert T.tree_children(tp, w) == J.tree_children(jp, w)
            assert T.tree_neighbors(tp, w) == J.tree_neighbors(jp, w)
        assert T.is_spanning_tree(tp, members) and J.is_spanning_tree(jp, members)
        m = {w: (w * 7) % 5 for w in members}
        assert T.encode_members(m) == J.encode_members(m)
        assert T.decode_members(J.encode_members(m)) == J.decode_members(T.encode_members(m))


@pytest.mark.parametrize("seed", range(4))
def test_protocol_runs_equal_the_jax_package(seed):
    """The same interleaving of adopt / add / remove / self-rejoin on a
    ``Topology`` of each package: after every step the epoch, members,
    parents, neighbours, root and successor are equal."""
    r = random.Random(seed)
    degree = r.randint(1, 4)
    jt, tt = J.Topology(0, range(8), degree=degree, boot_id=3), T.Topology(0, range(8), degree=degree, boot_id=3)
    for _ in range(300):
        op = r.randrange(4)
        if op == 0:
            w = r.randrange(8)
            out = [t.propose_remove(w) for t in (jt, tt)]
        elif op == 1:
            w, boot = r.randrange(12), r.randrange(5)
            out = [t.propose_add(w, boot=boot) for t in (jt, tt)]
        elif op == 2:
            members = {w: r.randrange(5) for w in r.sample(range(12), r.randint(1, 8))}
            num, boot, prop = r.randint(0, 300), r.randrange(5), r.randrange(8)
            out = [t.adopt(mod.TreeEpoch(num, boot, prop), dict(members)) for mod, t in ((J, jt), (T, tt))]
        else:
            out = [t.propose_self() for t in (jt, tt)]
        view = [(t.epoch_num(), (t.epoch.num, t.epoch.boot, t.epoch.proposer), t.members(), t.parents(), sorted(t.neighbors()), t.root(),
                 t.successor(), t.is_root()) for t in (jt, tt)]
        assert view[1] == view[0]
        assert repr(out[1]) == repr(out[0]).replace("mqtt_tpu.", "mqtt_tpu_torch.")


@pytest.mark.parametrize("seed", range(4))
def test_summaries_equal_the_jax_package(seed):
    """Counted blooms of each package through the same adds and discards
    of seeded filters: the wire bytes, generations, fill ratios and every
    topic probe are equal; unions of the plain bits likewise."""
    r = random.Random(seed)
    segs = ["a", "b", "c", "dd", "+", "#", "$SYS", "x"]

    def filt():
        return "/".join(r.choice(segs) for _ in range(r.randint(1, 4)))

    jb, tb = J.CountedBloom(512), T.CountedBloom(512)
    live = []
    for _ in range(400):
        if live and r.random() < 0.35:
            f = live.pop(r.randrange(len(live)))
            jb.discard(f)
            tb.discard(f)
        else:
            f = filt()
            live.append(f)
            jb.add(f)
            tb.add(f)
        assert tb.generation == jb.generation
        assert T.summary_key(f) == J.summary_key(f)
    jbits, tbits = jb.bits(), tb.bits()
    assert (tbits.data, tbits.match_all) == (jbits.data, jbits.match_all)
    assert tbits.fill_ratio() == jbits.fill_ratio()
    for _ in range(300):
        topic = "/".join(r.choice(["a", "b", "c", "dd", "x", "y"]) for _ in range(r.randint(1, 5)))
        assert T.topic_keys(topic) == J.topic_keys(topic)
        assert tbits.might_match(topic) == jbits.might_match(topic)
    half = bytes(b & 0x55 for b in jbits.data)
    tu, ju = tbits.union(T.BloomBits(half, False)), jbits.union(J.BloomBits(half, False))
    assert (tu.data, tu.match_all) == (ju.data, ju.match_all)


@pytest.mark.parametrize("seed", range(3))
def test_duplicate_windows_equal_the_jax_package(seed):
    r = random.Random(seed)
    jd, td = J.DuplicateSuppressor(window=64), T.DuplicateSuppressor(window=64)
    for _ in range(3000):
        origin, boot, seq = r.randrange(4), r.randrange(3), r.randrange(200)
        epoch = (r.randrange(6), r.randrange(2), r.randrange(3)) if r.random() < 0.5 else None
        a = jd.route(origin, boot, seq, epoch) if epoch is not None else jd.seen(origin, boot, seq)
        b = td.route(origin, boot, seq, epoch) if epoch is not None else td.seen(origin, boot, seq)
        assert b == a
