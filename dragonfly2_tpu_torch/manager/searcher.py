"""Searcher: pick the scheduler cluster for an arriving peer.

Counterpart of ``dragonfly2_tpu/manager/searcher.py`` (reference
``manager/searcher/searcher.go:106-156``): weighted affinity scoring of
cluster scopes against the peer, slice match over zone match over CIDR
over hostname regex, plus a small bonus for the default cluster. An
operator's scorer, a ``searcher`` plugin (``common/plugins.py``) loaded by
``load_searcher_plugin``, replaces the built-in scoring.
"""

from __future__ import annotations

import ipaddress
import json
import re

from ..idl.messages import GetSchedulersRequest

W_SLICE = 0.4
W_ZONE = 0.25
W_CIDR = 0.2
W_HOSTNAME = 0.1
W_DEFAULT = 0.05


def _score(scopes: dict, req: GetSchedulersRequest, is_default: bool) -> float:
    score = W_DEFAULT if is_default else 0.0
    topo = req.topology
    if topo is not None:
        slices = scopes.get("slices") or []
        if topo.slice_name and topo.slice_name in slices:
            score += W_SLICE
        zones = scopes.get("zones") or []
        if topo.zone and topo.zone in zones:
            score += W_ZONE
    for cidr in scopes.get("cidrs") or []:
        try:
            if req.ip and ipaddress.ip_address(req.ip) in \
                    ipaddress.ip_network(cidr, strict=False):
                score += W_CIDR
                break
        except ValueError:
            continue
    pattern = scopes.get("hostname_regex") or ""
    if pattern:
        try:
            if req.hostname and re.search(pattern, req.hostname):
                score += W_HOSTNAME
        except re.error:
            pass
    return score


_plugin_searcher = None


def load_searcher_plugin(plugin_dir: str, name: str = "default") -> None:
    """Operator override of the scoring (reference searcher plugin slot,
    ``manager/searcher/plugin.go``): a ``searcher``-type plugin exposing
    ``find_scheduler_cluster(clusters, req) -> int | None`` replaces the
    built-in affinity scorer."""
    global _plugin_searcher
    from ..common import plugins
    impl, _meta = plugins.load(plugin_dir, "searcher", name)
    if not callable(getattr(impl, "find_scheduler_cluster", None)):
        raise plugins.PluginError(
            "searcher plugin lacks find_scheduler_cluster()")
    _plugin_searcher = impl


def find_scheduler_cluster(clusters: list[dict],
                           req: GetSchedulersRequest) -> int | None:
    """Best-scoring cluster id, or None when there are no clusters."""
    if _plugin_searcher is not None:
        return _plugin_searcher.find_scheduler_cluster(clusters, req)
    best_id, best_score = None, -1.0
    for c in clusters:
        scopes = c.get("scopes")
        scopes = json.loads(scopes) if isinstance(scopes, str) else (scopes or {})
        s = _score(scopes, req, bool(c.get("is_default")))
        if s > best_score:
            best_id, best_score = c["id"], s
    return best_id
