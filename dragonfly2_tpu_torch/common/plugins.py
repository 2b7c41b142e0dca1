"""Plugin loading: operator-supplied extensions from a plugin directory.

Counterpart of ``dragonfly2_tpu/common/plugins.py`` (reference
``internal/dfplugin/dfplugin.go:43-80``), with the same file contract: a
plugin is a module file ``df_plugin_<type>_<name>.py`` in the plugin dir
exposing

    def dragonfly_plugin_init(option: dict) -> tuple[object, dict]:
        return impl, {"type": "<type>", "name": "<name>"}

and the same checks (the init symbol is present, the metadata echoes the
requested type and name). Known types: ``evaluator`` (an object with an
``evaluate(child, parent, total_piece_count)`` method, consumed by
``scheduler.evaluator.make_evaluator``), ``source`` (a source client
registered for the schemes in ``meta["schemes"]``) and ``searcher`` (an
object with ``find_scheduler_cluster(clusters, req)``, consumed by
``manager.searcher.load_searcher_plugin``).

A plugin file names its own package when it imports one (a source
plugin's ``SourceResponse`` comes from ``dragonfly2_tpu_torch.source``
here). The module is executed under its ``df_plugin_<type>_<name>`` name
but never entered in ``sys.modules``, so both packages can load plugins
of the same name in one process.
"""

from __future__ import annotations

import importlib.util
import logging
import os
from typing import Any

log = logging.getLogger("df.plugins")

INIT_FUNC = "dragonfly_plugin_init"
FILE_FORMAT = "df_plugin_{type}_{name}.py"


class PluginError(Exception):
    pass


def load(plugin_dir: str, type_: str, name: str,
         option: dict | None = None) -> tuple[Any, dict]:
    """Load one plugin; returns (impl, meta). Raises PluginError on any
    contract violation (missing file or symbol, metadata mismatch)."""
    path = os.path.join(plugin_dir, FILE_FORMAT.format(type=type_, name=name))
    # dflint: disable=DF001 — one manifest stat at service start, before traffic
    if not os.path.exists(path):
        raise PluginError(f"plugin not found: {path}")
    spec = importlib.util.spec_from_file_location(
        f"df_plugin_{type_}_{name}", path)
    if spec is None or spec.loader is None:
        raise PluginError(f"cannot load plugin module: {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    init = getattr(module, INIT_FUNC, None)
    if init is None:
        raise PluginError(f"{path}: missing {INIT_FUNC}()")
    impl, meta = init(dict(option or {}))
    if not isinstance(meta, dict) or not meta:
        raise PluginError(f"{path}: empty plugin metadata")
    if meta.get("type") != type_:
        raise PluginError(f"{path}: plugin type {meta.get('type')!r} != "
                          f"requested {type_!r}")
    if meta.get("name") != name:
        raise PluginError(f"{path}: plugin name {meta.get('name')!r} != "
                          f"requested {name!r}")
    log.info("loaded plugin %s/%s from %s", type_, name, path)
    return impl, meta


def discover(plugin_dir: str, type_: str) -> list[str]:
    """Names of the plugins of one type in the dir."""
    # dflint: disable=DF001 — plugin-dir scan at service start, before traffic
    if not os.path.isdir(plugin_dir):
        return []
    prefix = f"df_plugin_{type_}_"
    # dflint: disable=DF001 — plugin-dir scan at service start, before traffic
    return [fn[len(prefix):-3] for fn in sorted(os.listdir(plugin_dir))
            if fn.startswith(prefix) and fn.endswith(".py")]


def load_source_plugins(plugin_dir: str) -> int:
    """Load every ``source`` plugin and register its schemes in the origin
    client registry (reference ``pkg/source/plugin.go``). Returns the
    number registered; a bad plugin is skipped loudly, since a broken
    optional extension must not take the daemon down with it."""
    from ..source.client import client_for, register_client

    n = 0
    for name in discover(plugin_dir, "source"):
        try:
            impl, meta = load(plugin_dir, "source", name)
            schemes = list(meta.get("schemes") or [name])
            for scheme in schemes:
                # a plugin must not silently hijack a registered scheme
                # (a typo'd {'schemes': ['http']} would reroute all origin
                # traffic through it)
                try:
                    client_for(f"{scheme}://probe/x")
                except Exception:  # noqa: BLE001 - unknown scheme: free
                    continue
                raise PluginError(
                    f"scheme {scheme!r} already registered — refusing to "
                    f"override a built-in client")
            register_client(schemes, impl)
            n += 1
        except Exception as exc:  # noqa: BLE001 - isolate bad plugins
            log.error("source plugin %s skipped: %s", name, exc)
    return n
