"""The batch-block record shard map (counterpart of
``cxxnet_tpu/io/shard.py``).

Global batch k holds records [k*B, (k+1)*B); rank h of H owns rows
[h*b, (h+1)*b) of every global batch (b = B/H). Every record belongs to
exactly one rank, and the ranks' slices concatenated in rank order give
the unsharded record order. :meth:`ShardPlan.rederive` re-bases the map
at a global-batch boundary for a new world size: records before it were
read once under the old plan, records after it are owned once under
the new ones.

Iterators read it through ``shard_kind = batch`` (default ``stride``),
``shard_global_batch`` (B) and ``shard_start_record`` (the handoff
offset, 0 for a fresh epoch; it applies to the first pass only).
"""

from __future__ import annotations

from typing import Dict, List


def shard_owner(index: int, global_batch: int, num_hosts: int,
                start_record: int = 0) -> int:
    """The rank owning record ``index``, or -1 for records before the
    handoff point."""
    if index < start_record:
        return -1
    local = global_batch // num_hosts
    return ((index - start_record) % global_batch) // local


class ShardPlan:
    """One rank's view of the batch-block shard map."""

    __slots__ = ("host_rank", "num_hosts", "global_batch",
                 "start_record", "local_rows")

    def __init__(self, host_rank: int, num_hosts: int,
                 global_batch: int, start_record: int = 0):
        host_rank, num_hosts = int(host_rank), int(num_hosts)
        global_batch, start_record = int(global_batch), int(start_record)
        if num_hosts < 1 or not (0 <= host_rank < num_hosts):
            raise ValueError("bad shard rank %d/%d"
                             % (host_rank, num_hosts))
        if global_batch < 1 or global_batch % num_hosts != 0:
            raise ValueError(
                "shard_global_batch=%d must divide evenly across %d "
                "hosts (every host contributes an equal slice of "
                "every global batch)" % (global_batch, num_hosts))
        if start_record < 0 or start_record % global_batch != 0:
            raise ValueError(
                "shard_start_record=%d must sit on a global-batch "
                "boundary (multiple of %d): the elastic handoff point "
                "is an update boundary" % (start_record, global_batch))
        self.host_rank = host_rank
        self.num_hosts = num_hosts
        self.global_batch = global_batch
        self.start_record = start_record
        self.local_rows = global_batch // num_hosts

    def owns(self, index: int) -> bool:
        return shard_owner(index, self.global_batch, self.num_hosts,
                           self.start_record) == self.host_rank

    def owned_indices(self, n_records: int) -> List[int]:
        """Every record index in [0, n_records) this rank owns."""
        return [i for i in range(int(n_records)) if self.owns(i)]

    def slice_of_batch(self, k: int):
        """(lo, hi) record range this rank owns of global batch k
        (counted from the handoff point)."""
        base = self.start_record + int(k) * self.global_batch
        lo = base + self.host_rank * self.local_rows
        return lo, lo + self.local_rows

    def steady(self) -> "ShardPlan":
        """The same map without the handoff offset: the plan of every
        pass after the resumed one."""
        if not self.start_record:
            return self
        return ShardPlan(self.host_rank, self.num_hosts,
                         self.global_batch, 0)

    def rederive(self, host_rank: int, num_hosts: int,
                 batches_consumed: int) -> "ShardPlan":
        """The plan of a resized world, re-based ``batches_consumed``
        global batches past this plan's start. The global batch is a
        config constant: only the per-rank slice changes."""
        return ShardPlan(
            host_rank, num_hosts, self.global_batch,
            self.start_record
            + int(batches_consumed) * self.global_batch)

    def describe(self) -> Dict[str, int]:
        return {"host_rank": self.host_rank,
                "num_hosts": self.num_hosts,
                "global_batch": self.global_batch,
                "start_record": self.start_record}


def plan_from_params(part_index: int, num_parts: int,
                     global_batch: int,
                     start_record: int = 0) -> ShardPlan:
    """The plan of the iterator keys; the rank resolves as the strided
    split's does (``data.resolve_data_shard``)."""
    from .data import resolve_data_shard
    pi, nparts = resolve_data_shard(part_index, num_parts)
    return ShardPlan(pi, nparts, global_batch, start_record)
