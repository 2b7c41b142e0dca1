"""The reference's ``tests/test_dataplane.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

_SINK_OFF_LOOP = (
    "known difference 16: the port builds the device sink off the event "
    "loop, so set_content_info runs on the loop; the case awaits the "
    "build, so every span lands with the sink up, as in the reference")

SUBSTITUTIONS = (
    ("arr = np.array(view, copy=True)", "arr = view.clone()",
     "the port's DeviceIngest device_put_fn takes and returns a torch "
     "tensor (hbm_sink.py); the reference's returns the array jax.device_put "
     "would; the copy is the same"),
    ("""        conductor.set_content_info(len(blob))

        async def land(first: int):""",
     """        async def land(first: int):""", _SINK_OFF_LOOP),
    ("""        async def go():
            await asyncio.gather(*(land(i) for i in range(0, n_pieces, 2)))""",
     """        async def go():
            conductor.set_content_info(len(blob))
            await conductor._sink_build
            await asyncio.gather(*(land(i) for i in range(0, n_pieces, 2)))""",
     _SINK_OFF_LOOP),
    ('"_df_has_span_io"', '"df_span_write"',
     "the reference's library sets _df_has_span_io when its build has the "
     "span-IO export; the port builds its library from its own source, "
     "which always has it, so the case asks for the export itself"),
    ("devices=[object(), object()]", 'devices=["cpu", "cpu"]',
     "the port's DeviceIngest takes torch devices (ROADMAP ground rules: "
     "the CPU is named); the reference's object() placeholders stand in "
     "for JAX devices, and the case's own device_put_fn still does every "
     "copy"),
)

EXCLUDED = {}

globals().update(load("dataplane", SUBSTITUTIONS, EXCLUDED))
