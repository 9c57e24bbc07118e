"""Struct-of-arrays per-client state: the million-client layout (port of
``repro.core.soa``, DESIGN.md §12.1).

The eager layout — a list of :class:`~repro_torch.core.scheduler.
ClientState` objects, each holding its own residual tree and snapshot
list — costs O(population) host objects and Python attribute traffic a
round. :class:`ClientPool` stores the same state as stacked tensors
indexed by client id:

* **error-feedback residuals** — one ``(N, P)`` tensor on the run's device
  plus a host presence mask; a cohort's residuals are one
  ``index_select``, the writeback one ``index_copy_`` with distinct
  indices, and the block never leaves the device between rounds;
* **snapshot rings** — fixed-depth ring buffers ``(N, depth, p)`` with
  ``int32`` write cursors and fill counts (one ring a lifecycle lane: the
  flat ring plus one a partition group), in place of per-client lists;
* **lifecycle scalars** — ``version`` / ``last_refresh`` / drift baselines
  as numpy arrays: host policy code reads them client by client, and a
  tensor on the card would cost a device sync an access;
* **dispatched model snapshots** (async) — a host list of references:
  every client dispatched at one global version shares one params object.

Compatibility is by views: ``pool[ci]`` returns a :class:`ClientView` with
the ``ClientState`` attribute surface (``residual``, ``snapshots``,
``part_snapshots``, ...), every read and write passing through to the
pooled arrays, so the schedulers, the AE lifecycle and the rate
controllers run unchanged on either layout and the two layouts give
``torch.equal`` runs.

``ClientPool.state()`` writes the reference's npz tree and JSON metadata
key for key (``dtype`` as the numpy name, NaN baselines as ``null``), so
either package loads the other's struct-of-arrays checkpoint.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pytree import ravel

Tree = Any


def _index(cis, device: torch.device) -> Tuple[np.ndarray, torch.Tensor]:
    """Client ids as a host int32 array and an int64 index on ``device``."""
    cis_np = np.asarray(cis, dtype=np.int32).reshape(-1)
    return cis_np, torch.as_tensor(cis_np.astype(np.int64), device=device)


# =====================================================================
# ring buffers: (N, depth, p) storage for the per-lane snapshot rings
# =====================================================================
class RingStore:
    """Fixed-depth ring buffers for all N clients of one lane, allocated on
    the first append (the row width ``p`` is known only then) on the row's
    device. Logical index 0 is the oldest retained row; an append past
    ``depth`` overwrites the oldest — the eager ``list.append`` + ``del
    lst[:-depth]`` discipline of every snapshot consumer."""

    def __init__(self, n: int, depth: int):
        assert depth > 0
        self.n, self.depth = int(n), int(depth)
        self.buf: Optional[torch.Tensor] = None     # (N, depth, p) lazily
        self.cursor = np.zeros(self.n, dtype=np.int32)
        self.count = np.zeros(self.n, dtype=np.int32)

    @property
    def p(self) -> Optional[int]:
        return None if self.buf is None else int(self.buf.shape[-1])

    def _ensure(self, row: torch.Tensor) -> None:
        p = int(row.shape[-1])
        if self.buf is None:
            self.buf = torch.zeros((self.n, self.depth, p), dtype=row.dtype,
                                   device=row.device)
        else:
            assert p == self.p, (
                f"snapshot row width changed: ring holds {self.p}, got {p}")

    def append(self, ci: int, row: torch.Tensor) -> None:
        self._ensure(row)
        self.buf[ci, int(self.cursor[ci])] = row
        self.cursor[ci] = (self.cursor[ci] + 1) % self.depth
        self.count[ci] = min(self.count[ci] + 1, self.depth)

    def append_rows(self, cis, rows: torch.Tensor) -> None:
        """Cohort-wide append: one scatter for the whole batch."""
        self._ensure(rows)
        cis_np, idx = _index(cis, self.buf.device)
        slots = torch.as_tensor(self.cursor[cis_np].astype(np.int64),
                                device=self.buf.device)
        self.buf[idx, slots] = rows.to(self.buf.dtype)
        self.cursor[cis_np] = (self.cursor[cis_np] + 1) % self.depth
        self.count[cis_np] = np.minimum(self.count[cis_np] + 1, self.depth)

    def truncate(self, ci: int, keep: int) -> None:
        """Keep only the newest ``keep`` rows (``del lst[:-keep]``)."""
        self.count[ci] = min(self.count[ci], max(int(keep), 0))

    def row(self, ci: int, i: int) -> torch.Tensor:
        n = int(self.count[ci])
        if i < 0:
            i += n
        assert 0 <= i < n, f"ring index {i} out of range for {n} rows"
        phys = (int(self.cursor[ci]) - n + i) % self.depth
        return self.buf[ci, phys]

    def rows(self, ci: int) -> List[torch.Tensor]:
        return [self.row(ci, i) for i in range(int(self.count[ci]))]

    def clear(self, ci: int) -> None:
        self.count[ci] = 0


class RingView:
    """List-compatible view of one client's ring: the slice of the ``list``
    API the snapshot discipline uses (``append``, ``del v[:-k]``, ``len``,
    indexing, iteration, truthiness, ``torch.stack(list(v))``)."""

    __slots__ = ("_store", "_ci")

    def __init__(self, store: RingStore, ci: int):
        self._store, self._ci = store, ci

    def append(self, row) -> None:
        self._store.append(self._ci, row)

    def __delitem__(self, key) -> None:
        # the one deletion pattern of the snapshot consumers: ``del
        # v[:-k]`` (keep the newest k), with ``del v[:]`` and ``del v[:0]``
        assert isinstance(key, slice) and key.step is None and \
            key.start is None, f"unsupported ring deletion {key!r}"
        stop = key.stop
        if stop is None:                   # del v[:] → drop everything
            self._store.clear(self._ci)
        elif stop < 0:                     # del v[:-k] → keep newest k
            self._store.truncate(self._ci, -stop)
        elif stop > 0:                     # del v[:k] → drop oldest k
            self._store.truncate(self._ci, len(self) - stop)

    def __len__(self) -> int:
        return int(self._store.count[self._ci])

    def __bool__(self) -> bool:
        return len(self) > 0

    def __getitem__(self, i: int) -> torch.Tensor:
        return self._store.row(self._ci, i)

    def __iter__(self) -> Iterator[torch.Tensor]:
        return iter(self._store.rows(self._ci))


class _EmptyRing(RingView):
    """Read-only empty ring for an absent partition lane, so a write fails
    loudly instead of creating an unnamed ring."""

    __slots__ = ()

    def __init__(self):                    # no store
        pass

    def append(self, row) -> None:
        raise KeyError("appending to an absent partition ring — use "
                       "part_snapshots.setdefault(name, []) first")

    def __delitem__(self, key) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def __getitem__(self, i):
        raise IndexError("empty ring")

    def __iter__(self):
        return iter(())


# =====================================================================
# dict-shaped views over the per-partition state
# =====================================================================
class _PartSnapshots:
    """``ClientState.part_snapshots``-compatible mapping for one client:
    ``{group_name: ring}``, one :class:`RingStore` a group in the pool."""

    __slots__ = ("_pool", "_ci")

    def __init__(self, pool: "ClientPool", ci: int):
        self._pool, self._ci = pool, ci

    def setdefault(self, name: str, default) -> RingView:
        store = self._pool.part_rings.get(name)
        if store is None:
            store = RingStore(self._pool.n, self._pool.ring_depth)
            self._pool.part_rings[name] = store
        return RingView(store, self._ci)

    def get(self, name: str, default=None):
        store = self._pool.part_rings.get(name)
        if store is None or store.count[self._ci] == 0:
            return default if default is not None else None
        return RingView(store, self._ci)

    def __getitem__(self, name: str) -> RingView:
        return RingView(self._pool.part_rings[name], self._ci)

    def __contains__(self, name: str) -> bool:
        store = self._pool.part_rings.get(name)
        return store is not None and store.count[self._ci] > 0

    def items(self):
        return [(name, RingView(store, self._ci))
                for name, store in sorted(self._pool.part_rings.items())
                if store.count[self._ci] > 0]

    def keys(self):
        return [name for name, _ in self.items()]

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self.keys())

    def __bool__(self) -> bool:
        return len(self) > 0


class _PartScalars:
    """``part_last_refresh``/``part_baseline``-compatible mapping for one
    client over pooled per-group host arrays. Presence is in-band: ``-1``
    rounds and ``NaN`` baselines read as "never set", which every
    consumer's get-with-default treats as the eager dict's absent key."""

    __slots__ = ("_pool", "_ci", "_field")

    def __init__(self, pool: "ClientPool", ci: int, field: str):
        self._pool, self._ci, self._field = pool, ci, field

    def _arrays(self) -> Dict[str, np.ndarray]:
        return getattr(self._pool, self._field)

    def _is_set(self, v) -> bool:
        if self._field == "part_last_refresh_arr":
            return v >= 0
        return True                         # baselines: NaN encodes None

    def _decode(self, v):
        if self._field == "part_baseline_arr":
            return None if np.isnan(v) else float(v)
        return int(v)

    def get(self, name: str, default=None):
        arr = self._arrays().get(name)
        if arr is None or not self._is_set(arr[self._ci]):
            return default
        return self._decode(arr[self._ci])

    def __getitem__(self, name: str):
        arr = self._arrays().get(name)
        if arr is None or not self._is_set(arr[self._ci]):
            raise KeyError(name)
        return self._decode(arr[self._ci])

    def __setitem__(self, name: str, value) -> None:
        arrays = self._arrays()
        if name not in arrays:
            if self._field == "part_last_refresh_arr":
                arrays[name] = np.full(self._pool.n, -1, dtype=np.int64)
            else:
                arrays[name] = np.full(self._pool.n, np.nan,
                                       dtype=np.float64)
        arrays[name][self._ci] = (np.nan if value is None else value)

    def items(self):
        # a baseline set to None reads as never set, which every consumer's
        # get-with-default treats the same way
        out = []
        for name, arr in sorted(self._arrays().items()):
            v = arr[self._ci]
            if self._is_set(v) and not (self._field == "part_baseline_arr"
                                        and np.isnan(v)):
                out.append((name, self._decode(v)))
        return out

    def keys(self):
        return [k for k, _ in self.items()]

    def __iter__(self):
        return iter(self.keys())


# =====================================================================
# the pool and its per-client view
# =====================================================================
class ClientView:
    """One client's window into the pool: the ``ClientState`` attribute
    surface, every access passing through to the stacked arrays.
    ``pool[ci]`` makes a fresh one an access (two slots)."""

    __slots__ = ("_pool", "ci")

    def __init__(self, pool: "ClientPool", ci: int):
        self._pool, self.ci = pool, ci

    # -- error-feedback residual (model-shaped tree or None) -----------
    @property
    def residual(self) -> Optional[Tree]:
        """The client's row as a model-shaped tree: a copy, so a later
        writeback into the block does not change what a caller holds (the
        reference's arrays are immutable)."""
        p = self._pool
        if not p.res_mask[self.ci]:
            return None
        return p.unravel(p.residuals[self.ci].clone())

    @residual.setter
    def residual(self, value: Optional[Tree]) -> None:
        p = self._pool
        if value is None:
            p.res_mask[self.ci] = False
            return
        flat, _ = ravel(value)
        p.set_residual_rows([self.ci], flat[None, :])

    # -- lifecycle scalars ---------------------------------------------
    @property
    def version(self) -> int:
        return int(self._pool.versions[self.ci])

    @version.setter
    def version(self, v: int) -> None:
        self._pool.versions[self.ci] = int(v)

    @property
    def last_refresh(self) -> int:
        return int(self._pool.last_refresh_arr[self.ci])

    @last_refresh.setter
    def last_refresh(self, v: int) -> None:
        self._pool.last_refresh_arr[self.ci] = int(v)

    @property
    def ae_baseline(self) -> Optional[float]:
        v = self._pool.baseline_arr[self.ci]
        return None if np.isnan(v) else float(v)

    @ae_baseline.setter
    def ae_baseline(self, v: Optional[float]) -> None:
        self._pool.baseline_arr[self.ci] = np.nan if v is None else float(v)

    # -- async dispatch snapshot (one shared reference a version) ------
    @property
    def dispatched(self) -> Optional[Tree]:
        return self._pool.dispatched[self.ci]

    @dispatched.setter
    def dispatched(self, value: Optional[Tree]) -> None:
        self._pool.dispatched[self.ci] = value

    # -- snapshot rings ------------------------------------------------
    @property
    def snapshots(self) -> RingView:
        return RingView(self._pool.ring, self.ci)

    @property
    def part_snapshots(self) -> _PartSnapshots:
        return _PartSnapshots(self._pool, self.ci)

    @property
    def part_last_refresh(self) -> _PartScalars:
        return _PartScalars(self._pool, self.ci, "part_last_refresh_arr")

    @property
    def part_baseline(self) -> _PartScalars:
        return _PartScalars(self._pool, self.ci, "part_baseline_arr")


class ClientPool:
    """Struct-of-arrays storage for N clients' run state (module
    docstring). ``template`` fixes the model tree the residual and
    dispatched views ravel against, and the device of the residual block;
    ``ring_depth`` bounds every snapshot ring (at least the largest
    consumer's ``buffer_size`` — ``FederatedRun`` sizes it)."""

    def __init__(self, n: int, template: Tree, ring_depth: int = 16):
        flat, unravel = ravel(template)
        self.n = int(n)
        self.psize = int(flat.numel())
        self.dtype = flat.dtype
        self.device = flat.device
        self.unravel = unravel
        self.ring_depth = int(ring_depth)
        self.residuals: Optional[torch.Tensor] = None   # (N, P) lazily
        self.res_mask = np.zeros(self.n, dtype=bool)
        self.versions = np.zeros(self.n, dtype=np.int64)
        self.last_refresh_arr = np.full(self.n, -1, dtype=np.int64)
        self.baseline_arr = np.full(self.n, np.nan, dtype=np.float64)
        self.dispatched: List[Optional[Tree]] = [None] * self.n
        self.ring = RingStore(self.n, self.ring_depth)
        self.part_rings: Dict[str, RingStore] = {}
        self.part_last_refresh_arr: Dict[str, np.ndarray] = {}
        self.part_baseline_arr: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, ci: int) -> ClientView:
        assert 0 <= ci < self.n, f"client {ci} out of range"
        return ClientView(self, ci)

    def __iter__(self) -> Iterator[ClientView]:
        return (ClientView(self, ci) for ci in range(self.n))

    # ------------------------------------------------------------------
    # cohort-wide accessors: the gather/scatter fast path
    # ------------------------------------------------------------------
    def _ensure_residuals(self) -> None:
        if self.residuals is None:
            self.residuals = torch.zeros((self.n, self.psize),
                                         dtype=self.dtype, device=self.device)

    def gather_residuals(self, cis) -> Tuple[torch.Tensor, np.ndarray]:
        """Cohort residual rows ``(C, P)`` (zeros where absent) and the host
        presence mask ``(C,)`` — one ``index_select``."""
        self._ensure_residuals()
        cis_np, idx = _index(cis, self.device)
        return self.residuals.index_select(0, idx), self.res_mask[cis_np]

    def set_residual_rows(self, cis, rows: torch.Tensor) -> None:
        """Cohort writeback ``(C, P)`` — one ``index_copy_``; ``cis`` must
        be distinct (the order of duplicate writes is not fixed on CUDA)."""
        self._ensure_residuals()
        cis_np, idx = _index(cis, self.device)
        assert len(np.unique(cis_np)) == len(cis_np), "duplicate client ids"
        self.residuals.index_copy_(
            0, idx, rows.to(device=self.device, dtype=self.dtype))
        self.res_mask[cis_np] = True

    def scatter_residuals(self, cis, rows: torch.Tensor) -> None:
        self.set_residual_rows(cis, rows)

    # ------------------------------------------------------------------
    # checkpointing (DESIGN.md §12.4): arrays stay arrays
    # ------------------------------------------------------------------
    def state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(tensor tree, JSON meta), the reference's layout. The residual
        block, ring contents and dispatched rows ride the npz tree as whole
        arrays (cursor and count as int32 beside their ring); host scalars
        ride the JSON meta, which keeps int64 and float64 exact (NaN
        baselines as ``null``)."""
        def _ring(store: RingStore) -> Dict[str, torch.Tensor]:
            return {"buf": store.buf,
                    "cursor": torch.from_numpy(store.cursor.copy()),
                    "count": torch.from_numpy(store.count.copy())}

        tree: Dict[str, Any] = {}
        if self.residuals is not None:
            tree["residuals"] = self.residuals
        if self.ring.buf is not None:
            tree["ring"] = _ring(self.ring)
        parts = {name: _ring(store)
                 for name, store in self.part_rings.items()
                 if store.buf is not None}
        if parts:
            tree["part_rings"] = parts
        disp_idx = [ci for ci, d in enumerate(self.dispatched)
                    if d is not None]
        if disp_idx:
            tree["dispatched"] = torch.stack(
                [ravel(self.dispatched[ci])[0] for ci in disp_idx])

        def _floats(arr):
            return [None if np.isnan(v) else float(v) for v in arr]

        meta = {
            "n": self.n, "psize": self.psize,
            "ring_depth": self.ring_depth,
            "has_residuals": self.residuals is not None,
            "res_mask": [bool(b) for b in self.res_mask],
            "versions": [int(v) for v in self.versions],
            "last_refresh": [int(v) for v in self.last_refresh_arr],
            "baseline": _floats(self.baseline_arr),
            "ring_p": self.ring.p,
            "part_ring_p": {name: store.p
                            for name, store in self.part_rings.items()
                            if store.buf is not None},
            "part_last_refresh": {
                name: [int(v) for v in arr]
                for name, arr in sorted(self.part_last_refresh_arr.items())},
            "part_baseline": {
                name: _floats(arr)
                for name, arr in sorted(self.part_baseline_arr.items())},
            "dispatched_idx": disp_idx,
            "dtype": str(self.dtype).replace("torch.", ""),
        }
        return tree, meta

    @staticmethod
    def like_from_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
        """Shape-and-dtype structure of :meth:`state`'s tree (tensors on
        the meta device, no memory) for ``checkpoint.load_pytree``."""
        n = int(meta["n"])
        dt = getattr(torch, meta["dtype"])
        depth = int(meta["ring_depth"])

        def _empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        def _ring_like(p):
            return {"buf": _empty((n, depth, int(p)), dt),
                    "cursor": _empty((n,), torch.int32),
                    "count": _empty((n,), torch.int32)}

        like: Dict[str, Any] = {}
        if meta["has_residuals"]:
            like["residuals"] = _empty((n, int(meta["psize"])), dt)
        if meta["ring_p"] is not None:
            like["ring"] = _ring_like(meta["ring_p"])
        parts = {name: _ring_like(p)
                 for name, p in (meta.get("part_ring_p") or {}).items()}
        if parts:
            like["part_rings"] = parts
        if meta.get("dispatched_idx"):
            like["dispatched"] = _empty(
                (len(meta["dispatched_idx"]), int(meta["psize"])), dt)
        return like

    @classmethod
    def from_state(cls, tree: Dict[str, Any], meta: Dict[str, Any],
                   template: Tree) -> "ClientPool":
        """Rebuild a pool from :meth:`state` (either package's), its
        tensors on ``template``'s device."""
        pool = cls(int(meta["n"]), template,
                   ring_depth=int(meta["ring_depth"]))
        assert pool.psize == int(meta["psize"]), (
            f"checkpoint pool covers {meta['psize']} params, template has "
            f"{pool.psize}")
        dev = pool.device

        def _floats(vals):
            return np.array([np.nan if v is None else float(v)
                             for v in vals], dtype=np.float64)

        def _host_i32(t: torch.Tensor) -> np.ndarray:
            return t.cpu().numpy().astype(np.int32)

        def _ring(entry) -> RingStore:
            store = RingStore(pool.n, pool.ring_depth)
            store.buf = entry["buf"].to(dev)
            store.cursor = _host_i32(entry["cursor"])
            store.count = _host_i32(entry["count"])
            return store

        pool.res_mask = np.asarray(meta["res_mask"], dtype=bool)
        pool.versions = np.asarray(meta["versions"], dtype=np.int64)
        pool.last_refresh_arr = np.asarray(meta["last_refresh"],
                                           dtype=np.int64)
        pool.baseline_arr = _floats(meta["baseline"])
        if meta["has_residuals"]:
            pool.residuals = tree["residuals"].to(dev)
        if meta["ring_p"] is not None:
            pool.ring = _ring(tree["ring"])
        for name in (meta.get("part_ring_p") or {}):
            pool.part_rings[name] = _ring(tree["part_rings"][name])
        for name, vals in (meta.get("part_last_refresh") or {}).items():
            pool.part_last_refresh_arr[name] = np.asarray(vals,
                                                          dtype=np.int64)
        for name, vals in (meta.get("part_baseline") or {}).items():
            pool.part_baseline_arr[name] = _floats(vals)
        for k, ci in enumerate(meta.get("dispatched_idx") or []):
            pool.dispatched[int(ci)] = pool.unravel(
                tree["dispatched"][k].to(dev))
        return pool
