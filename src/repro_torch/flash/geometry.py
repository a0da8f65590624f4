"""SSD / NAND geometry (paper Fig 1, §6 target SSD)."""
from __future__ import annotations

import dataclasses

PAGE_KB = 16
PAGE_BYTES = PAGE_KB * 1024
PAGE_BITS = PAGE_BYTES * 8          # 131072 cells per wordline-page


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    """The §6 evaluation SSD: 16 ch x 8 dies x 4 planes = 512 planes."""
    channels: int = 16
    dies_per_channel: int = 8
    planes_per_die: int = 4
    blocks_per_plane: int = 1024
    pages_per_block: int = 2304      # MLC pages (1152 wordlines x 2)
    page_kb: int = PAGE_KB
    channel_bw_gbps: float = 1.2     # NAND->controller, GB/s per channel
    host_bw_gbps: float = 8.0        # PCIe Gen4 x4

    @property
    def planes(self) -> int:
        return self.channels * self.dies_per_channel * self.planes_per_die

    @property
    def dies(self) -> int:
        return self.channels * self.dies_per_channel

    @property
    def page_bytes(self) -> int:
        return self.page_kb * 1024

    @property
    def page_bits(self) -> int:
        return self.page_bytes * 8

    def pages_for_bytes(self, n_bytes: int) -> int:
        return -(-n_bytes // self.page_bytes)


@dataclasses.dataclass(frozen=True)
class PageAddress:
    channel: int
    die: int
    plane: int
    block: int
    page: int

    def plane_index(self, cfg: SSDConfig) -> int:
        return ((self.channel * cfg.dies_per_channel + self.die)
                * cfg.planes_per_die + self.plane)
