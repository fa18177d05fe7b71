"""Roofline terms of a traced dry-run cell on NVIDIA H100s (port of
``repro.roofline.analysis``).

  compute term    = flops_per_rank / peak bf16 flop/s
  memory term     = bytes_per_rank / HBM bandwidth
  collective term = sum over the collectives of each one's wire bytes
                    over the bandwidth of its group's links

The reference reads flops and bytes from compiled HLO; the port reads
them from the traced op stream (:mod:`repro_torch.roofline.op_cost`), so
the ``hlo_*`` names of :class:`Roofline` (``hlo_gflops``, ``hlo_gbytes``)
mean "of the traced op stream" here. They keep the reference's names so
that the engine's ``pool_model_from_dryrun`` and a results file read
alike. The reference's ``parse_collectives`` (over HLO text) has no
counterpart: the collectives come from the same trace.

Hardware model, all data-sheet values, none measured:

  * peaks: ``analysis.regions.MachineModel`` (NVIDIA H100 SXM: 989e12
    bf16 tensor-core flop/s, 3.35e12 B/s HBM3), the one source of these
    numbers in the port;
  * links: a collective whose group lies within one node of
    ``NODE_RANKS`` = 8 GPUs moves over NVLink 4 at ``NVLINK_BW`` = 450e9
    B/s a direction a GPU (18 links x 25 GB/s); one whose group spans
    nodes moves over the network at ``NETWORK_BW`` = 50e9 B/s a GPU (one
    400 Gb/s NDR NIC a GPU, as in a DGX H100). Ranks are numbered
    node-major: rank r lies in node r // 8.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.analysis.regions import MachineModel

_MACHINE = MachineModel()
PEAK_FLOPS = _MACHINE.tensor_flops_per_s   # bf16 per GPU
HBM_BW = _MACHINE.hbm_bytes_per_s          # bytes/s per GPU
NODE_RANKS = 8                             # GPUs joined by NVLink
NVLINK_BW = 450e9                          # bytes/s per GPU, one direction
NETWORK_BW = 50e9                          # bytes/s per GPU (one NIC)
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}


def link_of(ranks) -> str:
    """``nvlink`` when every global rank of a group lies in one node,
    else ``network``."""
    return "nvlink" if len({r // NODE_RANKS for r in ranks}) <= 1 \
        else "network"


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float            # per rank, of the traced op stream
    hlo_gbytes: float            # per rank, of the traced op stream
    floor_gbytes: float          # per rank analytic lower bound
    wire_gbytes: float           # per rank, every link
    model_gflops_total: float    # 6*N*D (or 6*N_active*D), whole step
    nvlink_gbytes: float = 0.0   # the share of wire_gbytes on NVLink
    compute_s: float = 0.0
    memory_s: float = 0.0        # from hlo_gbytes
    memory_floor_s: float = 0.0  # from floor_gbytes (lower bound)
    collective_s: float = 0.0
    bottleneck: str = ""         # using the floor memory term
    bottleneck_ub: str = ""      # using the traced bytes
    useful_flops_ratio: float = 0.0
    step_s: float = 0.0
    mfu: float = 0.0

    def finalize(self):
        self.compute_s = self.hlo_gflops * 1e9 / PEAK_FLOPS
        self.memory_s = self.hlo_gbytes * 1e9 / HBM_BW
        self.memory_floor_s = self.floor_gbytes * 1e9 / HBM_BW
        network = max(self.wire_gbytes - self.nvlink_gbytes, 0.0)
        self.collective_s = (self.nvlink_gbytes * 1e9 / NVLINK_BW
                             + network * 1e9 / NETWORK_BW)
        lo = {"compute": self.compute_s, "memory": self.memory_floor_s,
              "collective": self.collective_s}
        ub = {"compute": self.compute_s, "memory": self.memory_s,
              "collective": self.collective_s}
        self.bottleneck = max(lo, key=lo.get)
        self.bottleneck_ub = max(ub, key=ub.get)
        per_dev_model = self.model_gflops_total / self.chips
        self.useful_flops_ratio = (per_dev_model / self.hlo_gflops
                                   if self.hlo_gflops else 0.0)
        # roofline step time = max of the three overlappable terms
        self.step_s = max(lo.values())
        ideal = per_dev_model * 1e9 / PEAK_FLOPS
        self.mfu = ideal / self.step_s if self.step_s else 0.0
        return self

    def to_dict(self):
        return dict(self.__dict__)


def summarize(arch: str, shape: str, mesh: str, chips: int, totals,
              model_flops_total: float,
              floor_bytes: float = 0.0) -> Roofline:
    """The roofline of one cell from its :class:`~repro_torch.roofline.
    op_cost.CostTotals`."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_gflops=totals.flops / 1e9, hlo_gbytes=totals.bytes / 1e9,
        floor_gbytes=floor_bytes / 1e9,
        wire_gbytes=totals.total_wire / 1e9,
        nvlink_gbytes=totals.wire_by_link.get("nvlink", 0.0) / 1e9,
        model_gflops_total=model_flops_total / 1e9,
    ).finalize()


def memory_floor_bytes(cfg, shape, chips: int, mesh_devices: int,
                       opt_bytes_per_param: int = 8) -> float:
    """Analytic per-device HBM-traffic lower bound.

    train:   params read (fwd+bwd) + grads written + opt state r/w
             + one activations pass at remat boundaries
    prefill: params read + KV cache written + activations pass
    decode:  params read + full cache read + small writes
    """
    P = cfg.param_count()
    bpp = 2 if cfg.param_dtype == "bfloat16" else 4
    p_local = P * bpp / chips
    d = cfg.d_model
    tok_local = shape.tokens / chips
    act = tok_local * d * 2 * max(cfg.n_layers, 1)          # one r/w per layer
    if shape.kind == "train":
        return 3 * p_local + P * 4 / chips \
            + P * opt_bytes_per_param / chips + 2 * act
    kv_heads = max(cfg.kv_heads, 1)
    hd = cfg.resolved_head_dim or d
    if cfg.attention == "mla" and cfg.mla:
        kv_elem = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
    elif cfg.attention == "gqa":
        kv_elem = 2 * kv_heads * hd
    else:
        kv_elem = 0
    n_kv_layers = cfg.n_layers
    if cfg.hybrid is not None:
        n_kv_layers = cfg.n_layers // cfg.hybrid.shared_attn_every
    cache = (shape.global_batch * shape.seq_len * kv_elem * n_kv_layers
             * bpp / chips)
    if shape.kind == "prefill":
        return p_local + cache + 2 * act
    # decode: read whole cache once + params once
    state = 0.0
    if cfg.ssm is not None:
        s = cfg.ssm
        d_in = s.expand * d
        state += (shape.global_batch * (d_in // s.head_dim) * s.head_dim
                  * s.d_state * 4 * cfg.n_layers / chips)
    if cfg.rwkv is not None:
        H = d // cfg.rwkv.head_size
        state += (shape.global_batch * H * cfg.rwkv.head_size ** 2
                  * 4 * cfg.n_layers / chips)
    return p_local + cache + state


def model_flops(cfg, shape) -> float:
    """6*N_active*D for a train step (3x fwd), 2*N*D for prefill,
    2*N*D per generated token for decode."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch      # decode: one token per seq
