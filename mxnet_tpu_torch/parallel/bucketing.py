"""Gradient fusion buckets for the KVStore exchange (counterpart of
mxnet_tpu/parallel/bucketing.py: `bucket_target_bytes` :68, `finite_all`
:78, `Bucket` :90, `GradBucketer` :147, `plan` :164, `plan_signature`
:198).

`GradBucketer` packs many per-key gradients into a few flat,
dtype-homogeneous buffers, so the cross-process exchange issues one
collective per bucket instead of one per key. The rules are the JAX
package's, and over the same ``(key, shape, dtype, priority, lane)``
items `plan` gives the same buckets, in the same order, with the same
`plan_signature`:

- the target size is ``MXTPU_BUCKET_MB`` (default 4 MB); a key whose
  payload alone meets it rides alone, and a target of 0 gives every key
  its own bucket (the per-key exchange);
- buckets are dtype-homogeneous and split by an opaque ``lane`` tag (the
  distributed store keeps compressed keys apart from the others);
- issue order follows ``priority``: each bucket is as urgent as its most
  urgent member, higher first, ties in caller order.

Packing concatenates raveled gradients and unpacking slices the flat
back into per-key views, so a bucketed sum is bit-identical to per-key
sums. Plans are memoized on the item tuple.
"""
from __future__ import annotations

import hashlib
import math

import torch

from ..base import dtype_from_name, dtype_name, getenv
from ..observability import registry as _obs

__all__ = ["Bucket", "DEFAULT_BUCKET_MB", "GradBucketer",
           "bucket_target_bytes", "finite_all"]

DEFAULT_BUCKET_MB = 4.0

# fill ratios cluster in (0, 1], with lone oversized keys above 1
_FILL_BUCKETS = (0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0, 1.5, 2.0, 4.0,
                 8.0, float("inf"))

BUCKET_COUNT = _obs.counter("kvstore.bucket.count",
                            "Fusion buckets issued to the exchange")
BUCKET_KEYS = _obs.counter("kvstore.bucket.keys",
                           "Gradient keys carried inside fusion buckets")
BUCKET_FILL = _obs.histogram("kvstore.bucket.fill_ratio",
                             "Bucket payload bytes / target bucket bytes",
                             buckets=_FILL_BUCKETS)
PACK_SECONDS = _obs.histogram("kvstore.bucket.pack.seconds",
                              "Host time packing gradients into a bucket")
UNPACK_SECONDS = _obs.histogram(
    "kvstore.bucket.unpack.seconds",
    "Host time unpacking a reduced bucket into per-key views")


def bucket_target_bytes():
    """The configured bucket size in bytes (``MXTPU_BUCKET_MB``); 0
    disables bucketing."""
    mb = getenv("MXTPU_BUCKET_MB", DEFAULT_BUCKET_MB)
    return int(max(0.0, float(mb)) * (1 << 20))


def finite_all(flat):
    """A 0-d bool tensor on the flat's device: every element is finite.
    No host read; the numerics guard resolves it later."""
    return torch.isfinite(flat).all()


class Bucket:
    """One fusion bucket: an ordered set of same-dtype keys with their
    offsets into the flat buffer."""

    __slots__ = ("dtype", "lane", "keys", "shapes", "offsets", "sizes",
                 "total", "first_pos", "best_priority", "_sig")

    def __init__(self, dtype, lane, first_pos, priority):
        self.dtype = dtype_from_name(dtype)
        self.lane = lane
        self.keys = []
        self.shapes = []
        self.offsets = []
        self.sizes = []
        self.total = 0
        self.first_pos = first_pos
        self.best_priority = priority
        self._sig = None

    def add(self, key, shape, size):
        self.keys.append(key)
        self.shapes.append(tuple(shape))
        self.offsets.append(self.total)
        self.sizes.append(int(size))
        self.total += int(size)
        self._sig = None

    @property
    def nbytes(self):
        return self.total * self.dtype.itemsize

    @property
    def signature(self):
        """Hashable layout identity (the JAX package's, with the dtype by
        its name): what per-bucket state is keyed by."""
        if self._sig is None:
            self._sig = (dtype_name(self.dtype), self.lane,
                         tuple(zip(self.keys, self.shapes)))
        return self._sig

    def pack(self, grads):
        """A new flat buffer: the raveled gradients in bucket order."""
        return torch.cat([g.reshape(-1) for g in grads])

    def unpack(self, flat):
        """Per-key views of `flat` (a reduced buffer of this layout)."""
        return [flat[off:off + size].view(shape)
                for off, size, shape in zip(self.offsets, self.sizes,
                                            self.shapes)]


class GradBucketer:
    """Plans fusion buckets over a set of gradient keys.

    ``plan(items)`` takes ``(key, shape, dtype, priority, lane)`` tuples
    (dtype by MXNet name or as a torch dtype) and returns the buckets in
    issue order, memoized on the item tuple: repeated steps over the same
    parameter set reuse the layout and anything keyed by
    `Bucket.signature`.
    """

    def __init__(self, target_bytes=None):
        self.target_bytes = bucket_target_bytes() \
            if target_bytes is None else int(target_bytes)
        self._plans = {}

    def plan(self, items):
        items = tuple(items)
        cached = self._plans.get(items)
        if cached is not None:
            return cached
        # stable descending priority, caller order breaking ties
        order = sorted(range(len(items)), key=lambda j: -items[j][3])
        buckets, open_by_lane = [], {}
        for pos, j in enumerate(order):
            key, shape, dtype, priority, lane = items[j]
            dtype = dtype_from_name(dtype)
            size = math.prod(shape) if len(shape) else 1
            nb = size * dtype.itemsize
            lane_key = (dtype_name(dtype), lane)
            if self.target_bytes <= 0 or nb >= self.target_bytes:
                solo = Bucket(dtype, lane, pos, priority)
                solo.add(key, shape, size)
                buckets.append(solo)
                continue
            cur = open_by_lane.get(lane_key)
            if cur is not None and cur.nbytes + nb > self.target_bytes:
                buckets.append(cur)
                cur = None
            if cur is None:
                cur = open_by_lane[lane_key] = Bucket(dtype, lane, pos,
                                                      priority)
            cur.add(key, shape, size)
        buckets.extend(open_by_lane.values())
        # each bucket is as urgent as its first (most urgent) member
        buckets.sort(key=lambda b: (-b.best_priority, b.first_pos))
        if len(self._plans) > 64:
            # membership churn must not grow the memo without bound
            self._plans.clear()
        self._plans[items] = buckets
        return buckets

    def plan_signature(self, items_or_buckets):
        """Process-independent fingerprint of a layout: sha256 over the
        target size and the ordered bucket signatures (items are planned
        first)."""
        seq = list(items_or_buckets)
        if seq and not isinstance(seq[0], Bucket):
            seq = self.plan(tuple(seq))
        h = hashlib.sha256(str(self.target_bytes).encode())
        for b in seq:
            h.update(repr(b.signature).encode())
        return h.hexdigest()[:16]

    def clear(self):
        self._plans.clear()
