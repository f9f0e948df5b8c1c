"""Map a byte interval of the original .dat onto EC shard intervals.

Port of seaweedfs_tpu/ec/locate.py.

The .dat is striped row-major over the k data shards: first in rows of
k x 1GB "large blocks", then the remainder in rows of k x 1MB "small
blocks". Shard file i is the column: its large blocks, then its small
blocks (reference weed/storage/erasure_coding/ec_locate.go:16-98).

Unlike the reference (which hardcodes DataShardsCount in the row math),
everything here is parametrized by the context's data-shard count.
"""

from __future__ import annotations

from dataclasses import dataclass

from .context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE


@dataclass(frozen=True)
class Interval:
    """One contiguous run inside a single (large or small) block."""

    block_index: int  # index within the large-block area OR the small-block area
    inner_offset: int
    size: int
    is_large_block: bool
    large_block_rows: int  # number of large-block rows in the volume

    def to_shard_and_offset(
        self,
        data_shards: int,
        large_block_size: int = LARGE_BLOCK_SIZE,
        small_block_size: int = SMALL_BLOCK_SIZE,
    ) -> tuple[int, int]:
        """-> (shard_id, byte offset inside that shard's file)."""
        row = self.block_index // data_shards
        off = self.inner_offset
        if self.is_large_block:
            off += row * large_block_size
        else:
            off += self.large_block_rows * large_block_size + row * small_block_size
        return self.block_index % data_shards, off


def locate_data(
    offset: int,
    size: int,
    shard_size: int,
    data_shards: int,
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
) -> list[Interval]:
    """Intervals covering dat[offset : offset+size].

    `shard_size` decides where large blocks end: the authoritative value
    is dat_file_size // data_shards (reference ec_volume.go
    LocateEcShardNeedleInterval uses the .vif datFileSize).
    """
    large_rows = shard_size // large_block_size
    large_area = large_rows * large_block_size * data_shards

    if offset < large_area:
        is_large = True
        block_index, inner = divmod(offset, large_block_size)
    else:
        is_large = False
        block_index, inner = divmod(offset - large_area, small_block_size)

    intervals: list[Interval] = []
    while size > 0:
        block_len = large_block_size if is_large else small_block_size
        remaining = block_len - inner
        if remaining <= 0:
            block_index, is_large = _next_block(
                block_index, is_large, large_rows, data_shards
            )
            inner = 0
            continue
        take = min(size, remaining)
        intervals.append(Interval(block_index, inner, take, is_large, large_rows))
        size -= take
        block_index, is_large = _next_block(
            block_index, is_large, large_rows, data_shards
        )
        inner = 0
    return intervals


def _next_block(
    block_index: int, is_large: bool, large_rows: int, data_shards: int
) -> tuple[int, bool]:
    nxt = block_index + 1
    if is_large and nxt == large_rows * data_shards:
        return 0, False
    return nxt, is_large
