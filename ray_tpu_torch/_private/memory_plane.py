"""Memory attribution plane: who owns every byte of object store.

reference parity: `ray memory` (scripts.py:1921) backed by each core
worker's reference table (reference_count.h) joined with plasma
residency. Here the join happens at the GCS: `memory_collect` gathers

  - every core worker's reference-table snapshot (`cw_memory_snapshot`:
    owned objects + their location, local ref counts, submitted-arg
    pins, borrows held from remote owners, borrower pins granted,
    reader leases on pulled replicas, and — behind
    `Config.memory_callsite_capture` — the put()/.remote() callsite
    that created each owned object), and
  - every node's store residency (`nm_memory_snapshot` wraps
    `store_list`: size, pinned, leases, spilled, age),

into one cluster object table (`build_object_table`): per object, who
owns it, what holds it alive (pins / borrows / leases), and where bytes
are resident (primary = the owner's recorded location; other copies are
replicas). `group_rows` aggregates by callsite / actor / node / owner
for `ray_tpu memory --group-by`.

The leak probes (metrics_plane.Watchdog._probe_memory) consume compact
digests of the same data that ride the ordinary 2s metrics harvest, so
a leaked pin alerts within two harvest intervals with no extra fan-out:
an object pinned in a store that no live owner claims (dead-owner
leak), store reader leases no live process accounts for (orphaned
lease), and store-resident objects their owner already freed
(refcount-vs-residency mismatch).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

# digest keys (attached to metrics-plane process snapshots)
PROC_DIGEST_KEY = "memory"
STORE_DIGEST_KEY = "store_objects"


# ---------------------------------------------------------------------
# Cluster object table (the join behind `ray_tpu memory`)
# ---------------------------------------------------------------------


def _addr_key(addr: Any) -> Optional[str]:
    if not addr:
        return None
    return f"{addr[0]}:{addr[1]}"


def build_object_table(proc_snaps: List[Dict[str, Any]],
                       node_snaps: List[Dict[str, Any]]
                       ) -> List[Dict[str, Any]]:
    """Join reference-table snapshots with store residency into one row
    per object id. Owner fields come from the snapshot that OWNS the
    object; borrow/lease counts sum over every live process."""
    rows: Dict[str, Dict[str, Any]] = {}

    def row(oid: str) -> Dict[str, Any]:
        r = rows.get(oid)
        if r is None:
            r = rows[oid] = {
                "object_id": oid, "size": None,
                "owner": None, "owner_worker_id": None,
                "owner_actor_id": None, "owner_node_id": None,
                "owner_pid": None, "owner_state": None,
                "primary_store": None,
                "local_refs": 0, "arg_pins": 0,
                "borrower_pins": 0, "borrowers": 0,
                "replica_leases": 0, "borrow_holders": 0,
                "callsite": None,
                "residency": [], "resident_bytes": 0,
            }
        return r

    for snap in proc_snaps:
        for oid, rec in (snap.get("objects") or {}).items():
            r = row(oid)
            if rec.get("owned"):
                r["owner"] = snap.get("label")
                r["owner_worker_id"] = snap.get("worker_id")
                r["owner_actor_id"] = snap.get("actor_id")
                r["owner_node_id"] = snap.get("node_id")
                r["owner_pid"] = snap.get("pid")
                r["owner_state"] = rec.get("loc")
                r["primary_store"] = _addr_key(rec.get("store_addr"))
                if rec.get("size") is not None:
                    r["size"] = rec["size"]
                if rec.get("callsite"):
                    r["callsite"] = rec["callsite"]
            r["local_refs"] += int(rec.get("local_refs") or 0)
            r["arg_pins"] += int(rec.get("arg_pins") or 0)
            bp = rec.get("borrower_pins") or {}
            r["borrower_pins"] += sum(bp.values())
            r["borrowers"] += len(bp)
            r["replica_leases"] += int(rec.get("replica_leases") or 0)
            if rec.get("borrowed_from"):
                r["borrow_holders"] += 1

    for nsnap in node_snaps:
        node_id = nsnap.get("node_id")
        store_addr = _addr_key(nsnap.get("store_addr"))
        for ent in nsnap.get("store") or ():
            oid = ent["object_id"]
            r = row(oid)
            primary = (r["primary_store"] is not None
                       and store_addr == r["primary_store"])
            r["residency"].append({
                "node_id": node_id,
                "size": ent.get("size"),
                "pinned": ent.get("pinned"),
                "leases": ent.get("leases"),
                "spilled": ent.get("spilled"),
                "age_s": ent.get("age_s"),
                "primary": primary,
            })
            r["resident_bytes"] += int(ent.get("size") or 0)
            if r["size"] is None:
                r["size"] = ent.get("size")
    return sorted(rows.values(),
                  key=lambda r: -(r["resident_bytes"] or r["size"] or 0))


_GROUP_KEYS = ("callsite", "actor", "node", "owner")


def group_rows(rows: List[Dict[str, Any]], by: str,
               top: Optional[int] = None) -> List[Dict[str, Any]]:
    """Aggregate the object table for `--group-by callsite|actor|node|
    owner`: object count, bytes, and alive-holder totals per group."""
    if by not in _GROUP_KEYS:
        raise ValueError(f"group_by must be one of {_GROUP_KEYS}")
    groups: Dict[str, Dict[str, Any]] = {}
    for r in rows:
        if by == "callsite":
            key = r.get("callsite") or "(callsite capture off — set " \
                "RAY_TPU_memory_callsite_capture=1)"
        elif by == "actor":
            key = r.get("owner_actor_id") or "(no actor)"
        elif by == "node":
            nodes = [res["node_id"] for res in r["residency"]
                     if res.get("node_id")] or [r.get("owner_node_id")]
            key = None  # handled below (an object can span nodes)
        else:
            key = r.get("owner") or "(owner gone)"
        keys = ([str(n)[:12] if n else "(unknown node)" for n in nodes]
                if by == "node" else [key])
        for k in keys:
            g = groups.setdefault(k, {
                by: k, "objects": 0, "bytes": 0, "pinned": 0,
                "leases": 0, "borrower_pins": 0})
            g["objects"] += 1
            g["bytes"] += int(r.get("resident_bytes")
                              or r.get("size") or 0)
            g["pinned"] += sum(int(res.get("pinned") or 0)
                               for res in r["residency"])
            g["leases"] += sum(int(res.get("leases") or 0)
                               for res in r["residency"])
            g["borrower_pins"] += int(r.get("borrower_pins") or 0)
    out = sorted(groups.values(), key=lambda g: -g["bytes"])
    return out[:top] if top else out


# ---------------------------------------------------------------------
# Harvest digests (ride the metrics plane; inputs to the leak probes)
# ---------------------------------------------------------------------


def store_digest(store_list: List[Dict[str, Any]],
                 cap: int = 512) -> Tuple[List[List[Any]], bool]:
    """Held-alive store entries (pinned or leased) as compact tuples
    for the harvest: [oid, size, pinned, leases, spilled, age_s].
    Returns (entries, truncated)."""
    held = [[e["object_id"], e.get("size"), e.get("pinned"),
             e.get("leases"), e.get("spilled"), e.get("age_s")]
            for e in store_list
            if (e.get("pinned") or 0) > 0 or (e.get("leases") or 0) > 0]
    held.sort(key=lambda t: -(t[1] or 0))
    return held[:cap], len(held) > cap
