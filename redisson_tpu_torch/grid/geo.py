"""RGeo — → org/redisson/RedissonGeo.java over GEOADD/GEODIST/GEOPOS/
GEOSEARCH/GEOHASH (SURVEY.md §2.3 geo row).

Members map to (longitude, latitude); distances use the haversine great-
circle formula on the same Earth radius Redis uses (6372797.560856 m), so
GEODIST parity holds to Redis's own precision class.

The port's copy of ``redisson_tpu/grid/geo.py``.
"""

from __future__ import annotations

import math
from typing import Any, Optional

from redisson_tpu_torch.grid.base import GridObject, journaled

_EARTH_M = 6372797.560856  # Redis's earth radius (meters)
_UNITS = {"m": 1.0, "km": 1000.0, "mi": 1609.34, "ft": 0.3048}
_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def _haversine_m(lon1, lat1, lon2, lat2) -> float:
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lon2 - lon1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * _EARTH_M * math.asin(math.sqrt(a))


_LAT_MAX = 85.05112878  # Redis's geohash latitude clamp (web-mercator)


def _geohash_int52(lon: float, lat: float) -> int:
    """52-bit interleaved geohash cell id — the score Redis stores in
    the zset behind a geo key (26 lon bits + 26 lat bits, lon first),
    and the WITHHASH reply value.  Uses Redis's ±85.05112878° latitude
    range, NOT ±90 — the standard constants a client decodes with."""
    lat_off = (lat + _LAT_MAX) / (2 * _LAT_MAX)
    lon_off = (lon + 180.0) / 360.0
    ilat = min(int(lat_off * (1 << 26)), (1 << 26) - 1)
    ilon = min(int(lon_off * (1 << 26)), (1 << 26) - 1)
    out = 0
    for i in range(26):
        out |= ((ilon >> i) & 1) << (2 * i + 1)
        out |= ((ilat >> i) & 1) << (2 * i)
    return out


def _geohash_int52_decode(cell: int) -> tuple:
    """Center coordinates of a 52-bit cell (inverse of _geohash_int52)
    — the ≤2.7e-6° round-trip error is Redis's own precision class
    (GEOPOS there also returns cell centers, not the added values)."""
    ilon = ilat = 0
    for i in range(26):
        ilon |= ((cell >> (2 * i + 1)) & 1) << i
        ilat |= ((cell >> (2 * i)) & 1) << i
    lon = (ilon + 0.5) / (1 << 26) * 360.0 - 180.0
    lat = (ilat + 0.5) / (1 << 26) * (2 * _LAT_MAX) - _LAT_MAX
    return lon, lat


def _geohash(lon: float, lat: float, precision: int = 11) -> str:
    """Standard base32 geohash (the GEOHASH reply shape)."""
    lat_r = [-90.0, 90.0]
    lon_r = [-180.0, 180.0]
    bits = []
    even = True
    while len(bits) < precision * 5:
        if even:
            mid = (lon_r[0] + lon_r[1]) / 2
            if lon >= mid:
                bits.append(1)
                lon_r[0] = mid
            else:
                bits.append(0)
                lon_r[1] = mid
        else:
            mid = (lat_r[0] + lat_r[1]) / 2
            if lat >= mid:
                bits.append(1)
                lat_r[0] = mid
            else:
                bits.append(0)
                lat_r[1] = mid
        even = not even
    out = []
    for i in range(0, len(bits), 5):
        idx = 0
        for b in bits[i : i + 5]:
            idx = (idx << 1) | b
        out.append(_BASE32[idx])
    return "".join(out)


@journaled("add", "add_entries", "remove")
class Geo(GridObject):
    """A geo key IS a zset whose scores are 52-bit geohash cell ids —
    the Redis representation, verbatim: TYPE reports zset, ZSCORE/ZRANGE
    work on geo keys, GEOSEARCHSTORE destinations are readable by geo
    commands, and positions round-trip through the cell center (the same
    ≤1 m precision class as Redis GEOPOS)."""

    KIND = "zset"

    @staticmethod
    def _new_value():
        return {}  # member bytes -> float(52-bit cell id)

    @staticmethod
    def _coords(score: float) -> tuple:
        return _geohash_int52_decode(int(score))

    # -- writes ------------------------------------------------------------

    def add(self, longitude: float, latitude: float, member: Any) -> int:
        """→ RGeo#add: 1 if the member was new."""
        if not (-180.0 <= longitude <= 180.0 and -85.05112878 <= latitude <= 85.05112878):
            raise ValueError("coordinates out of range (GEOADD limits)")
        with self._store.lock:
            e = self._entry()
            mb = self._enc(member)
            new = mb not in e.value
            e.value[mb] = float(_geohash_int52(longitude, latitude))
            self._nc_bump()  # GEOPOS/GEODIST cached scalars retire
            return int(new)

    def add_entries(self, *entries: tuple) -> int:
        """add((lon, lat, member), ...) — returns count of new members.
        All-or-nothing like GEOADD: every coordinate validates BEFORE any
        member is inserted (a mid-list range error used to leave a
        partial mutation)."""
        for lon, lat, _m in entries:
            if not (
                -180.0 <= lon <= 180.0 and -85.05112878 <= lat <= 85.05112878
            ):
                raise ValueError("coordinates out of range (GEOADD limits)")
        with self._store.lock:
            return sum(self.add(lon, lat, m) for lon, lat, m in entries)

    def remove(self, member: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            gone = (
                e is not None
                and e.value.pop(self._enc(member), None) is not None
            )
            if gone:
                self._nc_bump()
            return gone

    # -- reads -------------------------------------------------------------

    def pos(self, *members: Any) -> dict:
        """→ RGeo#pos (GEOPOS): member -> (lon, lat), absent skipped.
        Rides the engine near cache keyed by the exact member set
        — repeated position polls of the same
        members skip the grid lock."""

        def compute():
            with self._store.lock:
                e = self._entry(create=False)
                if e is None:
                    return {}
                out = {}
                for m in members:
                    got = e.value.get(self._enc(m))
                    if got is not None:
                        out[m] = self._coords(got)
                return out

        key = ("pos", *(self._enc(m) for m in members))
        # Copy on the way out: the cached dict must never be mutated
        # by a caller into a poisoned hit.
        return dict(self._nc_scalar("geo", key, compute))

    def dist(self, a: Any, b: Any, unit: str = "m") -> Optional[float]:
        """→ RGeo#dist (GEODIST).  Near-cached like pos()."""
        scale = _UNITS[unit]

        def compute():
            with self._store.lock:
                e = self._entry(create=False)
                if e is None:
                    return None
                pa = e.value.get(self._enc(a))
                pb = e.value.get(self._enc(b))
                if pa is None or pb is None:
                    return None
                return (
                    _haversine_m(*self._coords(pa), *self._coords(pb))
                    / scale
                )

        key = ("dist", self._enc(a), self._enc(b), unit)
        return self._nc_scalar("geo", key, compute)

    def hash(self, *members: Any) -> dict:
        """→ RGeo#hash (GEOHASH)."""
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return {}
            out = {}
            for m in members:
                got = e.value.get(self._enc(m))
                if got is not None:
                    out[m] = _geohash(*self._coords(got))
            return out

    # -- search (GEOSEARCH) -------------------------------------------------

    def search_radius(self, longitude: float, latitude: float, radius: float,
                      unit: str = "m", count: Optional[int] = None,
                      with_dist: bool = False):
        """→ RGeo#search (BYRADIUS FROMLONLAT), nearest-first."""
        limit_m = radius * _UNITS[unit]
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            hits = []
            for mb, score in e.value.items():
                lon, lat = self._coords(score)
                d = _haversine_m(longitude, latitude, lon, lat)
                if d <= limit_m:
                    hits.append((d, mb))
        hits.sort(key=lambda t: t[0])
        if count is not None:
            hits = hits[:count]
        if with_dist:
            return [(self._dec(mb), d / _UNITS[unit]) for d, mb in hits]
        return [self._dec(mb) for _, mb in hits]

    def search_radius_from_member(self, member: Any, radius: float,
                                  unit: str = "m", count: Optional[int] = None,
                                  with_dist: bool = False):
        """→ RGeo#search (BYRADIUS FROMMEMBER)."""
        with self._store.lock:
            e = self._entry(create=False)
            origin = None if e is None else e.value.get(self._enc(member))
        if origin is None:
            raise ValueError(f"member {member!r} has no position")
        lon0, lat0 = self._coords(origin)
        return self.search_radius(lon0, lat0, radius, unit, count, with_dist)

    def search(self, *, member: Any = None, longitude: Optional[float] = None,
               latitude: Optional[float] = None, radius: Optional[float] = None,
               width: Optional[float] = None, height: Optional[float] = None,
               unit: str = "m", count: Optional[int] = None,
               count_any: bool = False, order: Optional[str] = None,
               with_coord: bool = False, with_dist: bool = False,
               with_hash: bool = False):
        """→ RGeo#search(GeoSearchArgs) / GEOSEARCH: origin is FROMMEMBER
        (``member``) or FROMLONLAT (``longitude``/``latitude``); shape is
        BYRADIUS (``radius``) or BYBOX (``width``×``height``, box
        half-extents measured along the lon/lat axes through the center,
        the Redis box test); ``order`` is "asc"/"desc"/None, ``count``
        with ``count_any`` stops at the first COUNT matches unsorted
        (COUNT n ANY).  Plain member list without with-flags; with any
        WITH* flag, a list of dicts {member, dist?, coord?, hash?}.
        ``dist`` is in ``unit`` like GEOSEARCH replies."""
        scale = _UNITS[unit]
        if (radius is None) == (width is None or height is None):
            raise ValueError("search needs exactly one of radius or width+height")
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            if member is not None:
                origin = e.value.get(self._enc(member))
                if origin is None:
                    raise ValueError(f"member {member!r} has no position")
                lon_c, lat_c = self._coords(origin)
            else:
                if longitude is None or latitude is None:
                    raise ValueError("search needs a member or lon/lat origin")
                lon_c, lat_c = float(longitude), float(latitude)
            hits = []
            for mb, score in e.value.items():
                lon, lat = self._coords(score)
                d = _haversine_m(lon_c, lat_c, lon, lat)
                if radius is not None:
                    if d > radius * scale:
                        continue
                else:
                    # BYBOX: per-axis great-circle distances from the
                    # center must fit the half-extents (Redis's box test).
                    dx = _haversine_m(lon_c, lat_c, lon, lat_c)
                    dy = _haversine_m(lon_c, lat_c, lon_c, lat)
                    if dx > width * scale / 2 or dy > height * scale / 2:
                        continue
                hits.append((d, mb, lon, lat))
                if count_any and count is not None and len(hits) >= count:
                    break  # COUNT n ANY: first n matches, no sort
        if order is not None or (count is not None and not count_any):
            # A plain COUNT (no ANY) implies nearest-first, like Redis.
            hits.sort(key=lambda t: t[0], reverse=(order == "desc"))
        if count is not None:
            hits = hits[:count]
        if not (with_coord or with_dist or with_hash):
            return [self._dec(mb) for _, mb, _, _ in hits]
        out = []
        for d, mb, lon, lat in hits:
            row = {"member": self._dec(mb)}
            if with_dist:
                row["dist"] = d / scale
            if with_coord:
                row["coord"] = (lon, lat)
            if with_hash:
                row["hash"] = _geohash_int52(lon, lat)
            out.append(row)
        return out

    def search_and_store(self, dest_name: str, *, store_dist: bool = False,
                         unit: str = "m", **kw) -> int:
        """→ GEOSEARCHSTORE: run :meth:`search` and store the result into
        the ScoredSortedSet ``dest_name`` — score is the 52-bit geohash
        cell id (the Redis zset-backed geo encoding), or the distance in
        ``unit`` with ``store_dist`` (STOREDIST).  Replaces the
        destination like Redis does; returns the stored count."""
        from redisson_tpu_torch.grid.collections import ScoredSortedSet

        dest = ScoredSortedSet(dest_name, self._client)
        # Members must land in the destination under the SAME byte
        # encoding this geo set uses (the RESP front door runs raw-codec
        # handles; re-encoding through the client default would store
        # different bytes than ZRANGE returns).
        dest._enc = self._enc
        dest._dec = self._dec
        with self._store.lock:  # atomic search+replace (RLock re-entry)
            rows = self.search(
                unit=unit, with_dist=True, with_coord=True, with_hash=True,
                **kw
            )
            dest.delete()
            for row in rows:
                score = row["dist"] if store_dist else float(row["hash"])
                dest.add(score, row["member"])
            return len(rows)

    def size(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            return 0 if e is None else len(e.value)
