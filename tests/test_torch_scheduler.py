"""The port's scheduler against the reference's, on the same seeded state.

Topology: ``link_type`` and ``classify`` over a grid of ``TopologyInfo``
pairs. Evaluator: ``evaluate``, ``explain`` and ``is_bad_node`` on seeded
``Resource`` states, built in both packages by the same operations; the
hosts, pieces and upload outcomes cross from the reference to the port
through the codec (reference ``dumps``, port ``loads``). Scheduling:
``find_parents``, ``refresh_parents`` and ``build_packet`` pick the same
parents in the same order under the same random seed (the reference
shuffles with the module ``random``; the port takes a ``random.Random``).
All comparisons are exact: the scores are the same float operations in
the same order.
"""

import itertools
import random

import numpy as np
import pytest

import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.idl import base as ref_base
from dragonfly2_tpu.scheduler import config as ref_config
from dragonfly2_tpu.scheduler import resource as ref_resource
from dragonfly2_tpu.scheduler.evaluator import Evaluator as RefEvaluator
from dragonfly2_tpu.scheduler.scheduling import Scheduling as RefScheduling
from dragonfly2_tpu.tpu import topology as ref_topology
from dragonfly2_tpu_torch.idl import base as port_base
from dragonfly2_tpu_torch.scheduler import config as port_config
from dragonfly2_tpu_torch.scheduler import resource as port_resource
from dragonfly2_tpu_torch.scheduler.evaluator import (Evaluator,
                                                      RTTEvaluator,
                                                      make_evaluator)
from dragonfly2_tpu_torch.common.plugins import PluginError
from dragonfly2_tpu_torch.scheduler.evaluator_ml import MLEvaluator
from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling
from dragonfly2_tpu_torch.scheduler.topology_store import TopologyStore
from dragonfly2_tpu_torch.tpu import topology as port_topology


def _cross(msg):
    """A reference message carried into the port through the codec."""
    return port_base.loads(ref_base.dumps(msg))


def _topologies() -> list:
    out = []
    for sl, zone, pod, coords in itertools.product(
            ("", "s1", "s2"), ("", "z1", "z2"), ("", "p1"),
            (None, (0, 0, 0), (1, 2, 0))):
        out.append(ref_msg.TopologyInfo(slice_name=sl, zone=zone, pod=pod,
                                        ici_coords=coords))
    return out + [None]


def test_link_type_and_classify_match_reference():
    topos = _topologies()
    port_topos = [_cross(t) if t is not None else None for t in topos]
    for (ra, pa), (rb, pb) in itertools.product(zip(topos, port_topos),
                                                repeat=2):
        for same_host in (False, True):
            assert (int(port_topology.link_type(pa, pb, same_host=same_host))
                    == int(ref_topology.link_type(ra, rb,
                                                  same_host=same_host)))
            rc = ref_topology.classify(ra, rb, same_host=same_host)
            pc = port_topology.classify(pa, pb, same_host=same_host)
            assert (int(pc.link), pc.same_pod, pc.dcn_hops, pc.ici) == \
                (int(rc.link), rc.same_pod, rc.dcn_hops, rc.ici)
        assert port_topology.pod_id(pa) == ref_topology.pod_id(ra)
    assert {int(k): v for k, v in port_topology.LINK_BANDWIDTH_SCORE.items()} \
        == {int(k): v for k, v in ref_topology.LINK_BANDWIDTH_SCORE.items()}
    assert {int(k): v for k, v in port_topology.LINK_TIER_NAMES.items()} \
        == {int(k): v for k, v in ref_topology.LINK_TIER_NAMES.items()}


def test_detect_honours_the_environment(monkeypatch):
    monkeypatch.setenv("TPU_SLICE_NAME", "slice-a")
    monkeypatch.setenv("DF_POD_ID", "pod-1")
    monkeypatch.setenv("DF_ZONE", "zone-b")
    monkeypatch.setenv("TPU_WORKER_ID", "3")
    monkeypatch.setenv("DF_ICI_COORDS", "1,2,3")
    port_topology.detect.cache_clear()
    try:
        t = port_topology.detect()
    finally:
        port_topology.detect.cache_clear()
    assert (t.slice_name, t.pod, t.zone, t.worker_index, t.ici_coords) == \
        ("slice-a", "pod-1", "zone-b", 3, (1, 2, 3))


def _build_states(seed: int):
    """The same seeded cluster state in both packages: (ref task, port
    task, peer ids)."""
    rng = np.random.default_rng(seed)
    topos = _topologies()[:-1]
    n_hosts, n_peers, total = 6, 10, 24
    hosts = [ref_msg.Host(
        id=f"host-{i}", ip=f"10.0.0.{i}", hostname=f"h{i}", port=9000 + i,
        download_port=8000 + i,
        type=ref_msg.HostType(int(rng.choice([0, 0, 0, 1, 2]))),
        topology=topos[int(rng.integers(len(topos)))],
        concurrent_upload_limit=int(rng.choice([0, 2, 3])))
        for i in range(n_hosts)]
    peer_host = [int(rng.integers(n_hosts)) for _ in range(n_peers)]
    states = [rng.choice(["running", "running", "succeeded", "back_source",
                          "failed", "pending"]) for _ in range(n_peers)]
    results = []   # (child, parent or -1, PieceResult)
    for child in range(n_peers):
        for num in rng.choice(total, int(rng.integers(0, total)),
                              replace=False):
            parent = int(rng.integers(-1, n_peers))
            results.append((child, parent, ref_msg.PieceResult(
                success=bool(rng.random() < 0.85),
                piece_info=ref_msg.PieceInfo(
                    piece_num=int(num), range_start=int(num) << 22,
                    range_size=1 << 22, digest=f"crc32:{int(num):08x}",
                    download_cost_ms=int(rng.integers(5, 400))))))
    edges = [(child, [int(p) for p in rng.choice(n_peers, 2, replace=False)
                      if p != child]) for child in range(n_peers)]
    peer_ids = [f"peer-{i}" for i in range(n_peers)]

    def build(res_mod, host_msgs, result_msgs):
        res = res_mod.Resource()
        task = res.get_or_create_task("t" * 64, "file:///origin")
        task.set_content_info(total << 22, 1 << 22, total)
        for i, pid in enumerate(peer_ids):
            host = res.store_host(host_msgs[peer_host[i]])
            peer = res.get_or_create_peer(pid, task, host)
            state = states[i]
            if state != "pending":
                peer.transit(res_mod.PeerState.RUNNING)
            if state in ("succeeded", "back_source", "failed"):
                peer.transit(res_mod.PeerState(state))
        for (child, parent, _), r in zip(results, result_msgs):
            c = task.peers[peer_ids[child]]
            if r.success:
                task.record_piece(r.piece_info)
                c.finished_pieces.add(r.piece_info.piece_num)
                c.observe_piece_cost(r.piece_info.download_cost_ms)
            if parent >= 0:
                task.peers[peer_ids[parent]].host.observe_upload(r.success)
        for child, parents in edges:
            task.set_parents(peer_ids[child], [peer_ids[p] for p in parents])
            task.peers[peer_ids[child]].last_offer_ids = {
                peer_ids[p] for p in parents[:1]}
        return task

    ref_task = build(ref_resource, hosts, [r for *_, r in results])
    port_task = build(port_resource, [_cross(h) for h in hosts],
                      [_cross(r) for *_, r in results])
    return ref_task, port_task, peer_ids


@pytest.mark.parametrize("seed", range(6))
def test_evaluator_matches_reference(seed):
    ref_task, port_task, ids = _build_states(seed)
    ref_ev, port_ev = RefEvaluator(), Evaluator()
    total = ref_task.total_piece_count
    for c, p in itertools.product(ids, repeat=2):
        rc, rp = ref_task.peers[c], ref_task.peers[p]
        pc, pp = port_task.peers[c], port_task.peers[p]
        assert port_ev.evaluate(pc, pp, total_piece_count=total) == \
            ref_ev.evaluate(rc, rp, total_piece_count=total)
        assert port_ev.explain(pc, pp, total_piece_count=total) == \
            ref_ev.explain(rc, rp, total_piece_count=total)
    for pid in ids:
        assert Evaluator.is_bad_node(port_task.peers[pid]) == \
            RefEvaluator.is_bad_node(ref_task.peers[pid])


@pytest.mark.parametrize("seed", range(6))
def test_scheduling_matches_reference(seed):
    ref_task, port_task, ids = _build_states(seed)
    for i, cid in enumerate(ids):
        for kind in ("find_parents", "refresh_parents"):
            random.seed(seed * 100 + i)
            ref_sched = RefScheduling(ref_config.SchedulerConfig(),
                                      RefEvaluator())
            ref_parents = getattr(ref_sched, kind)(ref_task.peers[cid])
            port_sched = Scheduling(port_config.SchedulerConfig(),
                                    Evaluator(),
                                    rng=random.Random(seed * 100 + i))
            port_parents = getattr(port_sched, kind)(port_task.peers[cid])
            assert [p.id for p in port_parents] == \
                [p.id for p in ref_parents]
            assert port_base.dumps(port_sched.build_packet(
                port_task.peers[cid], port_parents)) == ref_base.dumps(
                ref_sched.build_packet(ref_task.peers[cid], ref_parents))


@pytest.mark.parametrize("algorithm", ["ml", "nt", "plugin:x"])
def test_make_evaluator_refuses_what_is_not_ported(algorithm):
    """``nt`` without a topology store is refused (with one it is the
    ``RTTEvaluator``); ``ml`` is ported (the learned evaluator behind the
    heuristic floor, unbound until a model lands); ``plugin:<name>``
    loads its plugin, and a missing plugin file raises ``PluginError``
    rather than scoring with the heuristic under its name."""
    if algorithm == "ml":
        ev = make_evaluator(algorithm)
        assert type(ev) is MLEvaluator and ev.infer is None
    elif algorithm.startswith("plugin:"):
        with pytest.raises(PluginError, match="df_plugin_evaluator_x.py"):
            make_evaluator(algorithm)
    else:
        with pytest.raises(ValueError):
            make_evaluator(algorithm)
    if algorithm == "nt":
        store = TopologyStore()
        ev = make_evaluator(algorithm, topo_store=store)
        assert type(ev) is RTTEvaluator and ev.topo is store
    assert type(make_evaluator("default")) is Evaluator


def test_limits_are_the_reference_defaults():
    """The port's scheduling limits are constants; each equals the
    reference config's default for the same knob."""
    ref = ref_config.SchedulerConfig()
    assert (port_config.CANDIDATE_PARENT_LIMIT,
            port_config.FILTER_PARENT_LIMIT,
            port_config.RETRY_BACK_SOURCE_LIMIT,
            port_config.DEFAULT_BACK_SOURCE_CONCURRENT,
            port_config.BACK_SOURCE_TOTAL,
            port_config.PEER_TTL_S, port_config.TASK_TTL_S,
            port_config.HOST_TTL_S, port_config.PEER_GC_INTERVAL_S) == \
        (ref.candidate_parent_limit, ref.filter_parent_limit,
         ref.retry_back_source_limit, ref.back_source_concurrent,
         ref.back_source_total, ref.peer_ttl_s, ref.task_ttl_s,
         ref.host_ttl_s, ref.gc_interval_s)
    assert (port_resource.Host.DEFAULT_PEER_UPLOAD_LIMIT,
            port_resource.Host.DEFAULT_SEED_UPLOAD_LIMIT) == \
        (ref_resource.Host.DEFAULT_PEER_UPLOAD_LIMIT,
         ref_resource.Host.DEFAULT_SEED_UPLOAD_LIMIT)
