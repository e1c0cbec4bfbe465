"""The card the port runs on: one NVIDIA H100 SXM, as its data sheet
gives it (dense rates without sparsity, at the full 700 W power limit).

The dry run's roofline (:mod:`.roofline`) and ``chip_smoke.py``'s kernel
bounds read these constants.  They are published peaks, not
measurements: a card set below 700 W runs slower under load, so a share
of a peak is stated beside the card's power limit.
"""
from __future__ import annotations

import dataclasses

#: the precision of K5's products (``csrc/ssd_chunk.cu``): each f32
#: product is three TF32 tensor-core products
K5_PRECISION = "3xtf32"


@dataclasses.dataclass(frozen=True)
class H100Config:
    name: str = "NVIDIA H100 SXM"
    peak_flops_bf16: float = 989e12      # FLOP/s, bf16 (and fp16) tensor cores
    peak_flops_tf32: float = 495e12      # FLOP/s, TF32 tensor cores
    peak_flops_f32: float = 67e12        # FLOP/s, f32 outside the tensor cores
    peak_ops_int8: float = 1979e12       # OP/s, int8 tensor cores
    hbm_bandwidth: float = 3.35e12       # B/s
    hbm_bytes: float = 80e9              # device memory, B
    nvlink_bandwidth: float = 450e9      # B/s each way (900 GB/s both ways)
    # the cluster the dry run's meshes span: HGX H100 nodes of 8 cards
    # joined by NVLink, one 400 Gb/s NDR InfiniBand port (ConnectX-7) a
    # card between nodes (data-sheet figures, not measurements)
    cards_per_node: int = 8
    internode_bandwidth: float = 50e9    # B/s each way a card

    def link_bandwidth(self, ranks) -> float:
        """The bandwidth a ring over ``ranks`` (global ranks, ``r //
        cards_per_node`` its node) runs at: NVLink within one node, else
        its slowest hop, a card's InfiniBand port."""
        nodes = {r // self.cards_per_node for r in ranks}
        return self.nvlink_bandwidth if len(nodes) <= 1 else self.internode_bandwidth

    def peak(self, precision: str) -> float:
        """Peak rate of products in ``precision``: the name of a model
        dtype (``"bfloat16"``, ``"float32"``), or :data:`K5_PRECISION`.
        The port refuses TF32 for f32 matrix products
        (:func:`repro_torch.device.require_full_f32`), so they run at the
        f32 rate."""
        rates = {
            "bfloat16": self.peak_flops_bf16,
            "float32": self.peak_flops_f32,
            K5_PRECISION: self.peak_flops_tf32 / 3,
        }
        if precision not in rates:
            raise KeyError(f"no H100 peak for products in {precision!r}")
        return rates[precision]


H100 = H100Config()
