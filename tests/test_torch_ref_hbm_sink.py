"""The reference's ``tests/test_hbm_sink.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

_CPU = ("the port's DeviceIngest and make_mesh take torch devices and "
        "default to every CUDA device, raising without one (ROADMAP ground "
        "rules); the reference's eight jax.devices() of the test mesh are "
        "eight CPU devices named here")

SUBSTITUTIONS = (
    ("from dragonfly2_tpu_torch.idl.messages import LinkType, TopologyInfo\n",
     "from dragonfly2_tpu_torch.idl.messages import LinkType, TopologyInfo\n"
     "import torch\n\n_CPU_DEVICES = [torch.device(\"cpu\")] * 8\n", _CPU),
    ("jax.devices()", "_CPU_DEVICES", _CPU),
    ("DeviceIngest(1000)\n", "DeviceIngest(1000, devices=_CPU_DEVICES)\n",
     _CPU),
    ("mesh = make_mesh()\n", "mesh = make_mesh(devices=_CPU_DEVICES)\n", _CPU),
    ('make_mesh({"data": -1, "model": 2})',
     'make_mesh({"data": -1, "model": 2}, devices=_CPU_DEVICES)', _CPU),
    ('make_mesh({"data": 3})', 'make_mesh({"data": 3}, devices=_CPU_DEVICES)',
     _CPU),
    ("return jax.device_put(view, device)", "return view.to(device)",
     "the port's device_put_fn takes and returns a torch tensor "
     "(tpu/hbm_sink.py), where the reference's wraps jax.device_put"),
)

_PROBE = ("JAX only: `topology.probe_jax_devices`, the reference's bounded "
          "probe of the JAX runtime; the port probes CUDA "
          "(topology.probe_cuda_devices)")

EXCLUDED = {
    "TestDeviceIngestManifest::test_per_shard_dtype_and_shape": (
        "covered by tests/test_torch_hbm_sink.py::TestDeviceIngestManifest::"
        "test_per_shard_dtype_and_shape (the same input; the dtype is "
        "torch.float32 where the reference compares jnp.float32)"),
    "TestDeviceIngest::test_global_sharded_array": (
        "JAX only: `jax.device_put` of one global array sharded over the "
        "mesh (arr.sharding.device_set); the port's sharding mode returns "
        "per-device tensors, and chip_smoke.py phase 2 lands the same "
        "bytes on the card"),
    "TestDeviceIngest::test_training_steps_while_ingest_streams": (
        "covered by tests/test_torch_hbm_sink.py::TestDeviceIngest::"
        "test_training_steps_while_ingest_streams (the same 800 KB over "
        "eight shards with a 0.1 s put each; a torch train step loops "
        "where the reference's jax.jit step of trainer/models.py does)"),
    "TestJaxProbe::test_probe_ok_on_cpu_backend": _PROBE,
    "TestJaxProbe::test_wedged_runtime_disables_device_sink": _PROBE,
    "TestJaxProbe::test_wedge_cache_prevents_repeat_probe_stalls": _PROBE,
    "TestJaxProbe::test_probe_reports_error_not_timeout_when_jax_breaks":
        _PROBE,
}

globals().update(load("hbm_sink", SUBSTITUTIONS, EXCLUDED))
