"""System-level execution model: MCFlash vs OSC/ISC/ParaBit/Flash-Cosmos.

Generalises the paper's Fig 9 timelines (which this reproduces exactly for
the 2-operand 8 MB case) to k-operand chains over arbitrarily sized vectors,
for the Fig 10 application studies.  One **wave** = all 512 planes sensing
one page each = 8 MB of operand data.

Modelling assumptions (pure Python, float-equal to the JAX package's model):
- OSC: every operand streams to the host (8 t_EXT per operand-wave), sensing
  and channel DMA overlap the (bottleneck) host link.
- ISC: every operand crosses the channel (serialised 8 t_DMA per
  operand-wave, +1 pipeline fill); only the result leaves the SSD.
- MCFlash: aligned MLC pairs -> ceil(k/2) in-array senses; chain partials
  accumulate in the plane's cache latch (the same latch mechanics ParaBit
  exploits), so only the final result crosses the channel/host.
- ParaBit: (k-1) two-operand latch ops; each intermediate is re-staged
  through the SSD-internal DRAM (its documented reallocation path).
- Flash-Cosmos: MWS senses up to 16 operands at once (intra-block), ESP/SLC
  sensing is ~0.6x MLC latency; XOR falls back to 6-8 inter-latch steps.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.flash.geometry import SSDConfig
from repro_torch.flash.timing import TimingModel

PARADIGMS = ("osc", "isc", "parabit", "flashcosmos", "mcflash", "mcflash_nonaligned")


@dataclasses.dataclass(frozen=True)
class SystemModel:
    timing: TimingModel = TimingModel()
    config: SSDConfig = SSDConfig()
    # ParaBit per-intermediate DRAM reallocation cost, per wave (channel
    # crossings of the partial per die group).
    parabit_realloc_dma: int = 1
    # Flash-Cosmos ESP/SLC sensing latency ratio vs MLC LSB read.
    fc_slc_sense_scale: float = 0.6
    fc_max_operands: int = 16

    # -- per-op in-array sense latencies --------------------------------------
    def mcflash_sense_us(self, op: str) -> float:
        return self.timing.read_latency_us(op)

    def parabit_sense_us(self, op: str) -> float:
        t = self.timing
        if op in ("xor", "xnor"):
            return t.t_fixed_us + 7 * t.t_sense_us          # 6-8 latch steps
        return t.t_fixed_us + t.t_sense_us

    def flashcosmos_sense_us(self, op: str) -> float:
        t = self.timing
        if op in ("xor", "xnor"):
            return t.t_fixed_us + 7 * t.t_sense_us * self.fc_slc_sense_scale
        return t.t_fixed_us + t.t_sense_us * self.fc_slc_sense_scale

    # -- k-operand wave time ---------------------------------------------------
    def wave_time_us(self, paradigm: str, op: str, k: int,
                     result_to_host: bool = True,
                     result_write_back: bool = False) -> float:
        """Execution time for one 8 MB wave of a k-operand chain.

        result_to_host: the app consumes the result vector on the host
        (e.g. bitmap counts); in-storage paradigms must ship it out.
        result_write_back: the result persists in the SSD (e.g. ciphertext);
        OSC must stream it back in, in-storage paradigms keep it local.
        """
        t = self.timing
        ext_out = 8 * t.t_ext_us if result_to_host else 0.0
        if paradigm == "osc":
            back = 8 * t.t_ext_us if result_write_back else 0.0
            return t.t_r_avg_us + t.t_dma_us + 8 * k * t.t_ext_us + back
        if paradigm == "isc":
            # Result persisting in flash costs the controller a DMA back plus
            # a page-program wave; MCFlash/ParaBit/Flash-Cosmos results are
            # already in the plane page buffers (copyback overlaps sensing).
            back = (t.t_dma_us + t.t_prog_us) if result_write_back else 0.0
            return t.t_r_avg_us + (8 * (k - 1) + 1) * t.t_dma_us + ext_out + back
        if paradigm == "mcflash":
            senses = math.ceil(k / 2)
            return senses * self.mcflash_sense_us(op) + t.t_setfeature_us \
                + t.t_dma_us + ext_out
        if paradigm == "mcflash_nonaligned":
            senses = math.ceil(k / 2)
            realign = 2 * t.t_r_avg_us + t.t_prog_us        # per pair, copyback
            return senses * (self.mcflash_sense_us(op) + realign) \
                + t.t_setfeature_us + t.t_dma_us + ext_out
        if paradigm == "parabit":
            shuttle = (k - 2) * self.parabit_realloc_dma * t.t_dma_us if k > 2 else 0.0
            return (k - 1) * self.parabit_sense_us(op) + shuttle + t.t_dma_us + ext_out
        if paradigm == "flashcosmos":
            senses = max(1, math.ceil((k - 1) / (self.fc_max_operands - 1)))
            return senses * self.flashcosmos_sense_us(op) + t.t_dma_us + ext_out
        raise ValueError(paradigm)

    def exec_time_us(self, paradigm: str, op: str, k: int, operand_bits: int,
                     result_to_host: bool = True,
                     result_write_back: bool = False) -> float:
        """Total time for a k-operand chain over `operand_bits`-bit vectors."""
        bits_per_wave = self.config.planes * self.config.page_bits
        waves = max(1, math.ceil(operand_bits / bits_per_wave))
        return waves * self.wave_time_us(paradigm, op, k, result_to_host,
                                         result_write_back)


# --------------------------- application workloads ---------------------------

@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    op: str
    k_operands: int
    operand_bits_per_item: int
    items: int
    result_to_host: bool = False       # result vector consumed by the host
    result_write_back: bool = False    # result persists in the SSD

    @property
    def operand_bits(self) -> int:
        return self.operand_bits_per_item * self.items

    def run_functional(self, **kwargs) -> dict:
        """Execute one scaled-down wave of this workload through the
        :class:`~repro_torch.api.session.ComputeSession` layer (program
        operands, in-flash chain, controller combine), verifying against a
        host oracle.
        Forwards to :func:`repro_torch.api.workloads.run_workload`."""
        from repro_torch.api.workloads import run_workload  # deferred: api layers above

        return run_workload(self, **kwargs)


def image_segmentation(images: int = 10_000) -> Workload:
    """YUV colour recognition (§6.2): per class, AND across Y/U/V planes.

    800x600 px, 4 classes x 3 channel-match planes -> 4 independent
    3-operand AND chains per image; bits = 800*600 per plane per class.
    The per-class hit maps are reduced in place (counts leave the SSD).
    """
    return Workload("image_segmentation", "and", 3, 800 * 600 * 4, images)


def image_encryption(images: int = 5_000) -> Workload:
    """Bulk XOR with a key (§6.2): RGB 8-bit planes -> 24 bitplanes/image.
    The ciphertext persists in storage (OSC must stream it back)."""
    return Workload("image_encryption", "xor", 2, 800 * 600 * 24, images,
                    result_write_back=True)


def bitmap_index(months: int = 1, users: int = 800_000_000) -> Workload:
    """AND over daily activity bitmaps (§6.2); the result vector ships to the
    host, where the bit-count executes (offloaded per the paper)."""
    return Workload("bitmap_index", "and", 30 * months, users, 1,
                    result_to_host=True)


def speedup_table(workload: Workload, model: SystemModel | None = None) -> dict:
    """MCFlash speedup over each alternative for a workload."""
    model = model or SystemModel()
    times = {p: model.exec_time_us(p, workload.op, workload.k_operands,
                                   workload.operand_bits,
                                   workload.result_to_host,
                                   workload.result_write_back)
             for p in PARADIGMS}
    base = times["mcflash"]
    return {
        "times_us": times,
        "speedup_vs": {p: times[p] / base for p in PARADIGMS if p != "mcflash"},
    }
