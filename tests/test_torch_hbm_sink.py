"""The port's device sink, mesh and CUDA probe, held against the JAX package.

Ports of ``tests/test_hbm_sink.py`` run against ``dragonfly2_tpu_torch``
on explicit CPU devices, plus parity cases that write one seeded piece
sequence into both packages' ``DeviceIngest`` and compare every returned
array byte for byte (zero tolerance). JAX runs on the 8 CPU devices that
``tests/conftest.py`` sets up; the port gets eight ``torch.device("cpu")``
entries so that shard count, shard size and padding match one to one.
"""

import asyncio
import builtins
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from dragonfly2_tpu.tpu import hbm_sink as ref_sink
from dragonfly2_tpu.tpu import mesh as ref_mesh
from dragonfly2_tpu_torch.common.errors import Code, DFError
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl.messages import DeviceSink
from dragonfly2_tpu_torch.tpu import topology
from dragonfly2_tpu_torch.tpu.hbm_sink import CoverageMap, DeviceIngest
from dragonfly2_tpu_torch.tpu.mesh import make_mesh, named_sharding

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


def _jax_bytes(a) -> bytes:
    return np.asarray(a).reshape(-1).view(np.uint8).tobytes()


def _torch_bytes(t: torch.Tensor) -> bytes:
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _seeded_pieces(n: int, piece: int, seed: int):
    """(content, [(offset, length)]) with every piece once, shuffled, and
    a few seeded duplicates mixed in (endgame re-landings)."""
    rng = np.random.default_rng(seed)
    content = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    spans = [(o, min(piece, n - o)) for o in range(0, n, piece)]
    order = [spans[i] for i in rng.permutation(len(spans))]
    for i in rng.choice(len(spans), size=min(3, len(spans)), replace=False):
        order.insert(int(rng.integers(0, len(order))), spans[int(i)])
    return content, order


class TestCoverageMap:
    def test_merge_and_covers(self):
        c = CoverageMap()
        c.add(0, 10)
        c.add(20, 30)
        assert c.covers(0, 10) and not c.covers(5, 25)
        c.add(10, 20)
        assert c.covers(0, 30)
        assert c.covered_bytes() == 30

    def test_out_of_order_overlaps(self):
        c = CoverageMap()
        c.add(50, 60)
        c.add(0, 5)
        c.add(3, 55)
        assert c.covers(0, 60)
        assert c.covered_bytes() == 60

    def test_duplicate_landing_counts_once(self):
        c = CoverageMap()
        c.add(0, 10)
        c.add(0, 10)
        c.add(2, 8)
        assert c.covered_bytes() == 10
        assert c.covers(0, 10)

    def test_boundary_mid_piece_spans(self):
        c = CoverageMap()
        c.add(6, 14)
        assert c.covers(6, 10) and c.covers(10, 14)
        assert not c.covers(0, 10) and not c.covers(10, 20)
        c.add(0, 6)
        assert c.covers(0, 10)

    def test_adjacent_ranges_merge(self):
        c = CoverageMap()
        c.add(0, 10)
        c.add(10, 20)
        assert c.covers(0, 20)
        assert c._ranges == [(0, 20)]

    def test_empty_and_degenerate_queries(self):
        c = CoverageMap()
        assert c.covers(5, 5)
        assert not c.covers(0, 1)
        assert c.covered_bytes() == 0

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_parity_with_reference(self, seed):
        rng = np.random.default_rng(seed)
        ours, theirs = CoverageMap(), ref_sink.CoverageMap()
        for _ in range(200):
            s = int(rng.integers(0, 1000))
            e = s + int(rng.integers(1, 50))
            ours.add(s, e)
            theirs.add(s, e)
            q = int(rng.integers(0, 1000))
            qe = q + int(rng.integers(0, 80))
            assert ours.covers(q, qe) == theirs.covers(q, qe)
        assert ours._ranges == theirs._ranges
        assert ours.covered_bytes() == theirs.covered_bytes()


class TestDeviceIngestManifest:
    def test_named_shards_ready_incrementally(self):
        done: list[str] = []
        di = DeviceIngest(
            24, devices=[CPU, CPU],
            shard_specs=[("a", 0, 10), ("b", 10, 6), ("tail", 20, 4)],
            on_shard_ready=lambda n, _t: done.append(n))
        di.write(0, bytes(range(12)))     # completes a; b partial
        di.drain(timeout=10)
        assert done == ["a"]
        di.write(12, bytes(range(12, 24)))
        res = di.result(timeout=10)
        assert set(res) == {"a", "b", "tail"}
        assert res["a"].tolist() == list(range(10))
        assert res["b"].tolist() == [10, 11, 12, 13, 14, 15]
        assert res["tail"].tolist() == [20, 21, 22, 23]
        assert set(done) == {"a", "b", "tail"}

    def test_gap_bytes_never_transfer(self):
        di = DeviceIngest(24, devices=[CPU], shard_specs=[("a", 0, 8)])
        di.write(0, bytes(8))
        res = di.result(timeout=10)
        assert set(res) == {"a"}

    def test_per_shard_dtype_and_shape(self):
        di = DeviceIngest(16, devices=[CPU],
                          shard_specs=[("w", 0, 16, "float32", [2, 2])])
        di.write(0, np.arange(4, dtype=np.float32).tobytes())
        arr = di.result(timeout=10)["w"]
        assert arr.shape == (2, 2) and arr.dtype == torch.float32
        assert float(arr[1][1]) == 3.0

    def test_incomplete_shard_named_in_error(self):
        di = DeviceIngest(16, devices=[CPU],
                          shard_specs=[("a", 0, 8), ("b", 8, 8)])
        di.write(0, bytes(8))
        with pytest.raises(RuntimeError, match="b"):
            di.result(timeout=5)

    def test_bad_specs_rejected(self):
        with pytest.raises(ValueError, match="bad range"):
            DeviceIngest(16, devices=[CPU], shard_specs=[("a", 8, 16)])
        with pytest.raises(ValueError, match="itemsize"):
            DeviceIngest(16, devices=[CPU],
                         shard_specs=[("a", 0, 6, "float32", None)])
        with pytest.raises(ValueError, match="unsupported dtype"):
            DeviceIngest(16, devices=[CPU],
                         shard_specs=[("a", 0, 8, "complex64", None)])
        with pytest.raises(ValueError, match="incompatible"):
            DeviceIngest(16, sharding=named_sharding(make_mesh(devices=CPU8)),
                         shard_specs=[("a", 0, 16)])

    @pytest.mark.parametrize("seed", [0, 1])
    def test_parity_manifest_dtypes_shapes_gaps(self, seed):
        """bfloat16, float32 and int8 specs with gaps between them: the
        same seeded, shuffled, duplicate-bearing pieces into both sinks;
        every named array's dtype, shape and bytes must agree exactly."""
        specs = [("emb", 0, 64 * 32 * 2, "bfloat16", [64, 32]),
                 ("norm", 4200, 32 * 2, "bfloat16", [32]),
                 ("bias", 5000, 4 * 96, "float32", [4, 24]),
                 ("q8", 6001, 777, "int8", None),
                 ("flat", 7000, 300, "", None)]
        content, order = _seeded_pieces(8000, 333, seed)
        ours = DeviceIngest(len(content), devices=CPU8, shard_specs=specs)
        theirs = ref_sink.DeviceIngest(len(content), devices=jax.devices(),
                                       shard_specs=specs)
        for off, n in order:
            ours.write(off, content[off:off + n])
            theirs.write(off, content[off:off + n])
        got, want = ours.result(timeout=30), theirs.result(timeout=30)
        assert list(got) == list(want)
        for name, start, size, dtype, shape in specs:
            assert str(got[name].dtype) == f"torch.{want[name].dtype}"
            assert tuple(got[name].shape) == tuple(want[name].shape)
            assert _torch_bytes(got[name]) == _jax_bytes(want[name]) \
                == content[start:start + size]


    # a requested subset of a six-tensor manifest: two adjacent specs
    # (one staged segment), one apart, gaps and unrequested tensors between
    SUBSET = [("emb", 0, 64 * 32 * 2, "bfloat16", [64, 32]),
              ("norm", 4096, 32 * 2, "bfloat16", [32]),
              ("q8", 6001, 777, "int8", None)]
    UNREQUESTED = [(4160, 5000), (5000, 5384), (7000, 7300)]

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_parity_subset_specs(self, seed):
        """A subset-spec sink fed only the pieces covering its specs (the
        requested-subset pull) against the reference's subset-spec sink:
        same names, bytes, dtypes and shapes; staging holds only the
        specs' bytes."""
        content, order = _seeded_pieces(8000, 333, seed)
        covering = [(o, n) for o, n in order
                    if any(o < s + z and s < o + n
                           for _nm, s, z, _d, _sh in self.SUBSET)]
        ours = DeviceIngest(len(content), devices=CPU8,
                            shard_specs=self.SUBSET)
        theirs = ref_sink.DeviceIngest(len(content), devices=jax.devices(),
                                       shard_specs=self.SUBSET)
        assert ours.host.numel() == 4096 + 64 + 777 < len(content)
        assert ours.pinned_bytes == 0            # CPU staging: no pin
        for off, n in covering:
            ours.write(off, content[off:off + n])
            theirs.write(off, content[off:off + n])
        assert ours.done_fraction() == 1.0
        got, want = ours.result(timeout=30), theirs.result(timeout=30)
        assert list(got) == list(want) == ["emb", "norm", "q8"]
        for name, start, size, _dtype, _shape in self.SUBSET:
            assert str(got[name].dtype) == f"torch.{want[name].dtype}"
            assert tuple(got[name].shape) == tuple(want[name].shape)
            assert _torch_bytes(got[name]) == _jax_bytes(want[name]) \
                == content[start:start + size]

    def test_widen_pieces_outside_specs_are_skipped(self):
        """After a widen the download lands every piece, the sink still
        holds only its specs: pieces outside them are skipped without
        error or out-of-bounds write, as the reference's sink lands them
        without naming them."""
        content, order = _seeded_pieces(8000, 333, 7)
        ours = DeviceIngest(len(content), devices=[CPU],
                            shard_specs=self.SUBSET)
        theirs = ref_sink.DeviceIngest(len(content), devices=jax.devices(),
                                       shard_specs=self.SUBSET)
        for start, end in self.UNREQUESTED:      # outside every spec
            ours.write(start, content[start:end])
        assert ours.done_fraction() == 0.0
        for off, n in order:
            ours.write(off, content[off:off + n])
            theirs.write(off, content[off:off + n])
        got, want = ours.result(timeout=30), theirs.result(timeout=30)
        assert list(got) == list(want)
        for name, start, size, _dtype, _shape in self.SUBSET:
            assert _torch_bytes(got[name]) == _jax_bytes(want[name]) \
                == content[start:start + size]
        with pytest.raises(ValueError, match="beyond content"):
            ours.write(7990, bytes(20))


class TestDeviceIngest:
    def test_shards_land_on_all_devices(self):
        content = np.random.default_rng(0).integers(
            0, 255, 1_000_000, dtype=np.uint8)
        raw = content.tobytes()
        ingest = DeviceIngest(len(raw), devices=CPU8)
        piece = 100_000
        order = list(range(0, len(raw), piece))
        order = order[1::2] + order[0::2]
        for off in order:
            ingest.write(off, raw[off:off + piece])
        arrays = ingest.result()
        assert len(arrays) == 8
        flat = torch.cat(arrays).numpy()[:len(raw)]
        assert np.array_equal(flat, content)

    def test_sharded_result_in_mesh_order(self):
        mesh = make_mesh({"data": 8}, devices=CPU8)
        raw = bytes(range(256)) * 1000
        ingest = DeviceIngest(len(raw), sharding=named_sharding(mesh, "data"))
        for off in range(0, len(raw), 64 * 1024):
            ingest.write(off, raw[off:off + 64 * 1024])
        arrays = ingest.result()
        assert len(arrays) == 8
        assert sum(a.numel() for a in arrays) == ingest.padded_length
        assert torch.cat(arrays).numpy()[:len(raw)].tobytes() == raw

    def test_incomplete_result_raises(self):
        ingest = DeviceIngest(1000, devices=[CPU])
        ingest.write(0, b"x" * 10)
        with pytest.raises(RuntimeError):
            ingest.result()

    def test_overlap_send_before_completion(self):
        ingest = DeviceIngest(8 * 1000, devices=CPU8)
        ingest.write(0, b"a" * 1000)  # completes shard 0 only
        ingest.drain(timeout=10)
        assert ingest._shard_sent[0]
        assert not any(ingest._shard_sent[1:])

    def test_write_never_blocks_on_transfer(self):
        """write() must not wait on a copy: a deliberately slow copy proves
        the landing path and the event loop stay live while copies grind
        on the worker thread."""
        put_calls = []

        def slow_put(view, device):
            time.sleep(0.25)
            put_calls.append(device)
            return view.clone()

        raw = bytes(1000) * 8
        ingest = DeviceIngest(len(raw), devices=[CPU], shards_per_device=8,
                              device_put_fn=slow_put)

        async def scenario():
            ticks = 0

            async def heartbeat():
                nonlocal ticks
                while True:
                    await asyncio.sleep(0.01)
                    ticks += 1

            hb = asyncio.get_running_loop().create_task(heartbeat())
            t0 = time.monotonic()
            for off in range(0, len(raw), 1000):
                ingest.write(off, raw[off:off + 1000])
            write_elapsed = time.monotonic() - t0
            assert write_elapsed < 0.25, f"write blocked: {write_elapsed:.2f}s"
            arrays = await asyncio.to_thread(ingest.result, 30)
            hb.cancel()
            return ticks, arrays

        ticks, arrays = asyncio.run(scenario())
        assert len(put_calls) == 8
        assert len(arrays) == 8
        assert ticks > 50, f"event loop starved: only {ticks} heartbeats"

    def test_transfer_error_surfaces_in_result(self):
        def bad_put(view, device):
            raise RuntimeError("boom")

        ingest = DeviceIngest(100, devices=[CPU], device_put_fn=bad_put)
        ingest.write(0, b"x" * 100)
        with pytest.raises(RuntimeError):
            ingest.result(timeout=10)
        ingest._worker.join(5)   # raising result() must still stop the worker
        assert not ingest._worker.is_alive()

    def test_training_steps_while_ingest_streams(self):
        """A torch train loop keeps stepping (no deadlock, bounded stall)
        while the sink grinds slow copies on its worker thread."""
        def slow_put(view, device):
            time.sleep(0.1)
            return view.clone()

        raw = bytes(8) * 100_000
        ingest = DeviceIngest(len(raw), devices=[CPU], shards_per_device=8,
                              device_put_fn=slow_put)
        gen = torch.Generator().manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(7, 64), torch.nn.GELU(),
                                    torch.nn.Linear(64, 1))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        x = torch.randn(64, 7, generator=gen)
        y = torch.randn(64, 1, generator=gen)
        steps = {"n": 0}
        stop = threading.Event()

        def train_loop():
            while not stop.is_set():
                opt.zero_grad()
                loss = torch.nn.functional.mse_loss(model(x), y)
                loss.backward()
                opt.step()
                steps["n"] += 1

        t = threading.Thread(target=train_loop, daemon=True)
        t.start()
        try:
            for off in range(0, len(raw), 100_000):
                ingest.write(off, raw[off:off + 100_000])
            arrays = ingest.result(timeout=30)
        finally:
            stop.set()
            t.join(timeout=10)
        assert not t.is_alive(), "train loop deadlocked against ingest"
        assert len(arrays) == 8
        assert steps["n"] >= 3, f"training starved: {steps['n']} steps"

    def test_worker_self_terminates_when_complete(self):
        ingest = DeviceIngest(1000, devices=[CPU])
        ingest.write(0, b"y" * 1000)
        ingest._worker.join(5)
        assert not ingest._worker.is_alive()
        assert len(ingest.result(timeout=5)) == 1

    def test_default_devices_without_cuda_raise(self, monkeypatch):
        """The CPU is used only when named: no CUDA device is an error."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceIngest(1000)

    def test_cpu_staging_is_not_pinned(self):
        ingest = DeviceIngest(1000, devices=[CPU])
        assert not ingest.host.is_pinned()
        assert ingest.pin_seconds == 0.0
        ingest.close()

    @pytest.mark.parametrize("seed,n,spd", [(0, 1_000_003, 1), (1, 777_777, 2),
                                           (2, 4096, 1)])
    def test_parity_whole_file(self, seed, n, spd):
        """One seeded, out-of-order, duplicate-bearing piece sequence into
        both sinks: equal geometry and byte-identical arrays."""
        content, order = _seeded_pieces(n, 65_536, seed)
        ours = DeviceIngest(n, devices=CPU8, shards_per_device=spd)
        theirs = ref_sink.DeviceIngest(n, devices=jax.devices(),
                                       shards_per_device=spd)
        for off, ln in order:
            ours.write(off, content[off:off + ln])
            theirs.write(off, content[off:off + ln])
        assert (ours.n_shards, ours.shard_bytes, ours.padded_length) == \
            (theirs.n_shards, theirs.shard_bytes, theirs.padded_length)
        got, want = ours.result(timeout=30), theirs.result(timeout=30)
        assert len(got) == len(want) == ours.n_shards
        for g, w in zip(got, want):
            assert _torch_bytes(g) == _jax_bytes(w)

    def test_parity_sharding_mode(self):
        """``sharding=``: the reference's global array, shard by shard,
        against the port's per-device tensors in mesh order."""
        content, order = _seeded_pieces(123_457, 10_000, 7)
        n = len(content)
        ours = DeviceIngest(n, sharding=named_sharding(
            make_mesh({"data": 8}, devices=CPU8), "data"))
        theirs = ref_sink.DeviceIngest(n, sharding=ref_mesh.named_sharding(
            ref_mesh.make_mesh({"data": 8}), "data"))
        for off, ln in order:
            ours.write(off, content[off:off + ln])
            theirs.write(off, content[off:off + ln])
        got, want = ours.result(timeout=30), theirs.result(timeout=30)
        shards = sorted(want.addressable_shards, key=lambda s: s.index[0].start)
        assert len(got) == len(shards) == 8
        for g, s in zip(got, shards):
            assert _torch_bytes(g) == _jax_bytes(s.data)
        assert _torch_bytes(torch.cat(got)) == _jax_bytes(want)


class TestMesh:
    def test_make_mesh_axes(self):
        mesh = make_mesh({"data": -1, "model": 2}, devices=CPU8)
        assert mesh.shape["model"] == 2
        assert mesh.shape["data"] == 4
        with pytest.raises(ValueError):
            make_mesh({"data": 3}, devices=CPU8)

    @pytest.mark.parametrize("axes", [None, {"data": 8}, {"data": -1, "model": 2},
                                      {"a": 2, "b": -1, "c": 2},
                                      {"data": 3}, {"data": -1, "model": 3}])
    def test_parity_axis_rules(self, axes):
        try:
            want = dict(ref_mesh.make_mesh(axes).shape)
        except ValueError:
            with pytest.raises(ValueError):
                make_mesh(axes, devices=CPU8)
            return
        assert make_mesh(axes, devices=CPU8).shape == want


class TestCudaProbe:
    def test_probe_ok_without_a_card(self):
        status, payload = topology.probe_cuda_devices(timeout_s=60)
        assert status == "ok"
        n_cuda, first, total = payload
        assert n_cuda == total == torch.cuda.device_count()
        assert (first is None) == (n_cuda == 0)

    def test_wedged_runtime_disables_device_sink(self, monkeypatch, tmp_path):
        """After a timed-out probe the process must never touch CUDA again:
        the daemon's sink factory refuses instead of hanging the event loop;
        the conductor catches the refusal and continues to disk."""
        monkeypatch.setattr(topology, "_runtime_ok", topology._runtime_ok)
        monkeypatch.setattr(topology, "_local_probe_hung", True)
        assert topology.runtime_wedged()
        daemon = Daemon(DaemonConfig(workdir=str(tmp_path), hostname="w",
                                     device="cpu"))
        factory = daemon.device_sink_builder(DeviceSink(enabled=True))
        with pytest.raises(DFError) as exc:
            factory(1 << 20)
        assert exc.value.code == Code.UNAVAILABLE
        monkeypatch.setattr(topology, "_local_probe_hung", False)
        ingest = factory(1 << 20)
        assert ingest is not None
        ingest.close()

    def test_wedge_cache_prevents_repeat_probe_stalls(self, monkeypatch,
                                                      tmp_path):
        cache = str(tmp_path / "wedge-marker")
        monkeypatch.setattr(topology, "_wedge_cache_path", lambda: cache)
        monkeypatch.setattr(topology, "_local_probe_hung", False)
        monkeypatch.setattr(topology, "_runtime_ok", topology._runtime_ok)
        real_import = builtins.__import__

        def hanging_import(name, *a, **kw):
            if name == "torch":
                time.sleep(20)
            return real_import(name, *a, **kw)

        monkeypatch.setattr(builtins, "__import__", hanging_import)
        status, _ = topology.probe_cuda_devices(timeout_s=0.3)
        assert status == "timeout"
        assert os.path.exists(cache), "timeout must write the wedge marker"
        monkeypatch.setattr(builtins, "__import__", real_import)
        t0 = time.monotonic()
        status, _ = topology.probe_cuda_devices(timeout_s=30)
        assert status == "timeout"
        assert time.monotonic() - t0 < 1.0, "cached wedge must be instant"
        assert topology.runtime_wedged()
        os.unlink(cache)
        status, _ = topology.probe_cuda_devices(timeout_s=60)
        assert status == "ok"
        assert not os.path.exists(cache), "success must clear the marker"

    def test_probe_reports_error_not_timeout_when_torch_breaks(
            self, monkeypatch):
        real_import = builtins.__import__

        def broken_import(name, *a, **kw):
            if name == "torch":
                raise ImportError("torch exploded (test)")
            return real_import(name, *a, **kw)

        monkeypatch.setattr(builtins, "__import__", broken_import)
        status, payload = topology.probe_cuda_devices(timeout_s=10)
        assert status == "error"
        assert "exploded" in str(payload)
