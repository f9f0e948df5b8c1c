"""Shared fleet-maintenance decision logic for EC volumes.

Port of seaweedfs_tpu/ec/fleet.py, whole. The volume server's cluster
half (server/volume_grpc.py) uses `grpc_addr`; the rest is for the shell
and the maintenance worker, which come later.

The shell's operator commands (``ec.scrub`` / ``ec.rebuild``) and the
maintenance worker's fleet tasks (``ec_scrub`` / ``ec_rebuild``) walk
the same holder map and make the same per-holder verdicts. The decision
kernel lives here exactly once so the two paths cannot drift: what
counts as missing, what counts as hurt, and when a holder is
quarantined-but-unrebuildable (< k verified-good local shards — the
case per-server repair can never fix and a peer-fetch rebuild must).
"""

from __future__ import annotations

__all__ = [
    "grpc_addr",
    "holder_maps",
    "holder_scrub_facts",
    "pick_rebuild_holder",
]


def grpc_addr(loc) -> str:
    """Location (public `url` host:port + `grpc_port`) -> the holder's
    gRPC address."""
    return f"{loc.url.split(':')[0]}:{loc.grpc_port}"


def holder_maps(shard_locs) -> tuple[dict, dict]:
    """Invert the master's ``lookup_ec`` map into per-holder views:
    ``by_url`` (url -> set of advertised shard ids) and ``loc_by_url``
    (url -> a Location carrying the grpc port)."""
    by_url: dict[str, set[int]] = {}
    loc_by_url: dict[str, object] = {}
    for sid, locs in shard_locs.items():
        for loc in locs:
            by_url.setdefault(loc.url, set()).add(int(sid))
            loc_by_url[loc.url] = loc
    return by_url, loc_by_url


def holder_scrub_facts(resp, advertised, data_shards: int) -> dict:
    """Fold one successful ``ScrubEcVolume`` response into the verdict
    both the shell and the fleet worker act on.

    ``missing`` is the real per-sid set difference (shards the master
    lists on this holder whose files the scrub did not find). A server
    that checked ZERO shards genuinely has no shard files — total local
    loss — so every advertised shard is missing; only a legacy server
    (``checked > 0`` with no ``checked_shards``) degrades to the count
    comparison in ``legacy_gone`` because per-sid ids are unknowable.

    ``unrebuildable``: hurt in any way AND fewer than ``data_shards``
    verified-good local shards, so local repair can never fix it.
    """
    advertised = set(int(s) for s in advertised)
    bad = sorted(int(x) for x in resp.bad_shards)
    quarantined = sorted(int(x) for x in resp.quarantined_shards)
    checked = int(resp.checked)
    if resp.checked_shards or checked == 0:
        missing = sorted(advertised - {int(x) for x in resp.checked_shards})
        legacy_gone = 0
    else:
        missing = []
        legacy_gone = max(0, len(advertised) - checked)
    hurt = bool(bad or missing or legacy_gone or quarantined)
    good = checked - len(bad)
    return {
        "checked": checked,
        "bad": bad,
        "missing": missing,
        "legacy_gone": legacy_gone,
        "quarantined": quarantined,
        "hurt": hurt,
        "good": good,
        "unrebuildable": hurt and good < data_shards,
    }


def pick_rebuild_holder(by_url: dict, smallest: bool = False) -> str:
    """The rebuild-holder heuristic: the BIGGEST holder (most local
    sources) for a local rebuild, the SMALLEST (the subset holder a
    local rebuild refuses on) for ``fromPeers``. Deterministic: ties
    break on the url."""
    key = lambda u: (len(by_url[u]), u)  # noqa: E731
    return min(by_url, key=key) if smallest else max(by_url, key=key)
