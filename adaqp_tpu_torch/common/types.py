"""Core enums and constants.

Reference: ``AdaQP/helper/typing.py:4-27`` defines ``DistGNNType``,
``BitType``, ``MessageType``, ``ProprogationMode``; run modes live in
``AdaQP/trainer/trainer.py:14-20``.  ``MessageType`` (p2p tags) is
dropped — collectives are order-deterministic.
"""
from __future__ import annotations

import enum

# Supported quantized message bit-widths (reference: BITS_SET,
# AdaQP/communicator/buffer.py:20)
BITS_SET = (2, 4, 8)
# Widths the ragged wire can carry per lane: the quantized set plus raw
# fp32 (b=32, no quantization, no params consumed). On fast fabrics
# quantize+pack can cost more than the wire it saves, so the adaptive MILP
# may assign 32 to fast channels and narrow widths to slow ones — enable with
# ``fp32_lanes`` (RunConfig) / ``bits_options`` (AssignerConfig). Beyond
# the reference (its BITS_SET is fixed; one fabric class per job).
WIRE_BITS_SET = (2, 4, 8, 32)


class GNNType(enum.Enum):
    """Model families (reference: DistGNNType, AdaQP/helper/typing.py)."""

    GCN = "gcn"
    SAGE = "sage"


class AggregatorType(enum.Enum):
    """GraphSAGE aggregator (reference: AdaQP/model/ops.py:34-67)."""

    MEAN = "mean"
    GCN = "gcn"


class Mode(enum.Enum):
    """Run modes (reference: QUNAT_PARA_MAP, AdaQP/trainer/trainer.py:14-20).

    VANILLA : fp32 messages, no overlap.
    ADAQP   : quantization + computation-communication overlap.
    ADAQP_Q : quantization only.
    ADAQP_P : overlap only (fp32 messages).
    """

    VANILLA = "Vanilla"
    ADAQP = "AdaQP"
    ADAQP_Q = "AdaQP-q"
    ADAQP_P = "AdaQP-p"

    @property
    def quantized(self) -> bool:
        return self in (Mode.ADAQP, Mode.ADAQP_Q)

    @property
    def overlapped(self) -> bool:
        return self in (Mode.ADAQP, Mode.ADAQP_P)

    @staticmethod
    def from_str(s: str) -> "Mode":
        for m in Mode:
            if m.value.lower() == s.lower():
                return m
        raise ValueError(f"unknown mode {s!r}; choose from {[m.value for m in Mode]}")


class Scheme(enum.Enum):
    """Bit-width assignment schemes (reference: AdaQP/assigner/assigner.py:20,38)."""

    UNIFORM = "uniform"
    RANDOM = "random"
    ADAPTIVE = "adaptive"

    @staticmethod
    def from_str(s: str) -> "Scheme":
        for m in Scheme:
            if m.value.lower() == s.lower():
                return m
        raise ValueError(f"unknown scheme {s!r}")
