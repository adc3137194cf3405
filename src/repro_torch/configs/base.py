"""The DFA system and model configurations (the port's own copies).

Field names, defaults and meanings are those of the reference
``DFAConfig`` and ``ModelConfig`` so a configuration reads the same in
both packages. Only the fields the port reads (or refuses) are carried.
``MoEConfig`` and ``MLAConfig`` carry every field of the
reference's, and so do ``SSMConfig`` (the hybrid and ssm families'),
``HybridConfig``, ``EncDecConfig`` (the encdec family's) and
``VisionStubConfig`` (the vlm family's).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class DFAConfig:
    """The paper's own system configuration (Table I / Figs 2, 4).

    Defaults mirror the Tofino deployment: 2^17 flows per pipeline shard,
    10-entry history ring, 64 B RoCEv2 payload (45 B Marina vector + pad),
    20 ms monitoring period target.
    """

    flows_per_shard: int = 1 << 17        # 131,072 — classification table size
    history: int = 10                      # Fig 4 ring depth
    monitoring_period_us: int = 20_000     # 20 ms target interval
    logstar_bits: int = 7                  # mantissa bits kept by the log* LUT
    event_block: int = 1024                # packet events per extraction block
    report_capacity: int = 4096            # max reports routed per step/shard
    derived_dim: int = 96                  # Marina-style derived feature count
    # kernel selection: "auto" | "cuda" | "ref" (repro_torch.kernels
    # .dispatch). "auto" and "cuda" launch the hand-written kernels on
    # CUDA tensors; "ref" forces the plain PyTorch versions on any device
    kernel_backend: str = "auto"
    # wire schema version: "v1" (the paper's layout) | "v2" (u16 fields)
    wire_format: str = "v1"
    # sorted-event tile of the fused ingest (segment sums are cut at tile
    # boundaries); clamped to 256 and to the block's event count
    event_tile: int = 256
    # tuned-config registry JSON (repro_torch.kernels.tuning); "" = off.
    # REPRO_TUNING_REGISTRY beats it. A tuned K1 event tile for the exact
    # event count beats event_tile
    tuning_registry: str = ""
    # streaming driver: software-pipeline the period stream so period t's
    # enrich(+inference) half runs in the same loop body as period t+1's
    # ingest half (pipeline.run_periods_overlapped); output-identical to
    # the sequential chain by construction
    overlap_periods: bool = False
    # immediate-inference head on the enriched features: "none" |
    # "linear" | "mlp" (models.flow_head)
    inference_head: str = "none"
    inference_classes: int = 8         # verdict classes the head emits
    inference_hidden: int = 64         # mlp hidden width (linear ignores)
    # -- multi-pod (pod, shard) mesh ---------------------------------------
    # how a flow's home collector ring is chosen:
    #   "ingest"     — flow ids are minted from the ingest shard's range
    #                  (shard * flows_per_shard + slot): a report's home is
    #                  its ingest shard;
    #   "hash"       — flow id = FNV-1a hash of the stored five-tuple into
    #                  the global ring keyspace (n_shards * flows_per_shard),
    #                  home device = the range shard of that id (pod-major);
    #                  delivery is intra-pod, then cross-pod;
    #   "rendezvous" — highest-random-weight hashing over ``home_nodes``:
    #                  flow id = node_id * flows_per_shard + slot hash
    flow_home: str = "ingest"
    # pod axis size: DFASystem(cfg, n_shards=n) lays its n devices out as
    # (pods, n // pods), pod-major
    pods: int = 1
    # reporter ports per pod; 0 = one port per shard device. total_ports =
    # pods * ports_per_pod must be a multiple of the device count; each
    # device hosts total_ports / n_devices per-port Marina tables
    ports_per_pod: int = 0
    # per-PORT Marina table size; 0 = flows_per_shard
    reporter_slots: int = 0
    # per-PORT due-report capacity; 0 = report_capacity // total_ports
    port_report_capacity: int = 0
    # stage-2 (cross-pod) exchange: "padded" (worst-case buckets) |
    # "ragged" (pod-local rows stay home, remote rows pre-merged flow-major
    # into ``crosspod_capacity``-row segments; adds the crosspod_sent /
    # crosspod_messages metrics)
    crosspod_exchange: str = "padded"
    # ragged segment rows per destination pod; 0 = the worst case
    # (shards_per_pod x stage-1 bucket), at which ragged == padded
    crosspod_capacity: int = 0
    # logical node roster for flow_home="rendezvous": one strictly
    # increasing node id per device (pod-major); () = 0..n_devices-1
    home_nodes: Tuple[int, ...] = ()
    # snapshot the full DFAState every N completed periods (0 = never)
    snapshot_every_periods: int = 0
    # where stream()/ServingLoop write snapshots ("" = the caller passes a
    # directory to enable snapshotting)
    snapshot_dir: str = ""
    # keep-last-k snapshot GC (checkpoint.save's ``keep``)
    snapshot_keep: int = 3
    # -- continuous online serving (launch.serving) ----------------------
    # offered event rate of the trace-replay source, events/second; 0 =
    # line rate (one full event batch per period, no queueing)
    serve_offered_eps: float = 0.0
    # per-period latency budget (the SLO) in µs; 0 = monitoring_period_us
    serve_budget_us: int = 0
    # host ingest queue capacity in events, on top of the in-flight
    # batch; 0 = no carry-over (per-period drop accounting exact)
    serve_queue_events: int = 0
    # which events to shed when arrivals overflow the host queue:
    # "newest" (tail drop) | "oldest" (evict the head)
    drop_policy: str = "newest"
    # transport fault injection (data.faults.FaultSpec) between
    # translation and collector ingest; None = off
    fault_spec: Optional[Any] = None
    # what launch.elastic does when re-homing meets an unsplittable ring
    # row (live entries of one slot whose HRW winners differ):
    #   "fail" — raise with the count; "warn" — warn, count, and move the
    #   row by its first live entry's key
    rehome_collision_policy: str = "fail"

    def serve_budget_resolved_us(self) -> int:
        """The serving loop's per-period SLO (falls back to the paper's
        monitoring period)."""
        return self.serve_budget_us or self.monitoring_period_us

    def reporter_table_slots(self) -> int:
        """Per-port Marina table size (falls back to flows_per_shard)."""
        return self.reporter_slots or self.flows_per_shard

    def ring_region_bytes(self) -> int:
        """Shard-local collector ring footprint as the port holds it: 64 B
        entries plus a one-byte validity flag each (the reference counts
        4 B of validity)."""
        return self.flows_per_shard * self.history * (16 * 4 + 1)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (GShard-style top-k routing)."""

    num_experts: int
    top_k: int
    d_ff_expert: int                  # per-expert FFN hidden width
    num_shared_experts: int = 0       # always-on experts (deepseek-v3 style)
    d_ff_shared: int = 0              # hidden width of the shared expert(s)
    capacity_factor: float = 1.25     # per-expert buffer slack for dispatch
    router_dtype: str = "float32"
    # Layers [0, first_moe_layer) use a dense FFN of width ``d_ff_dense``.
    first_moe_layer: int = 0
    d_ff_dense: int = 0
    # deepseek-v3 routing details
    routed_scaling_factor: float = 1.0
    score_func: str = "softmax"       # "softmax" | "sigmoid" (deepseek-v3)
    moe_every: int = 1                # MoE FFN every k-th layer (llama4: 1)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (deepseek-v3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2/SSD block configuration (zamba2) or RWKV6 time-mix options."""

    state_dim: int = 64               # N — SSM state size per head
    head_dim: int = 64                # P — channels per head
    expand: int = 2                   # d_inner = expand * d_model
    conv_width: int = 4               # causal conv1d kernel size
    chunk_size: int = 128             # SSD chunked-scan block length
    n_groups: int = 1                 # B/C groups (mamba2)


@dataclass(frozen=True)
class HybridConfig:
    """Hybrid block schedule (zamba2: Mamba2 trunk + shared attention)."""

    attn_every: int = 6               # full attention block every k layers
    shared_attn: bool = True          # attention blocks share one weight set
    num_shared_blocks: int = 2        # zamba2 has 2 alternating shared blocks


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder split (whisper). The conv frontend is a STUB: the
    data pipeline provides precomputed frame embeddings
    (``data.tokens.add_modality_stub``)."""

    num_encoder_layers: int = 4
    num_frames: int = 1500            # whisper 30 s @ 50 Hz after conv stride 2


@dataclass(frozen=True)
class VisionStubConfig:
    """VLM frontend stub (llava-next). The batches carry precomputed patch
    embeddings already projected to d_model
    (``data.tokens.add_modality_stub``); anyres tiling is upstream."""

    num_patches: int = 2880           # anyres 5 tiles x 576 patches
    patch_embed_dim: int = 0          # 0 => already projected to d_model


@dataclass(frozen=True)
class ModelConfig:
    """One model architecture (the port's own copy of the reference's
    ``ModelConfig``, every family's fields).

    Families, all six of the reference's: ``"dense"`` (decoder-only
    GQA/MQA/MHA transformer), ``"moe"`` (decoder-only with MoE FFNs,
    optionally MLA attention), ``"hybrid"`` (a Mamba2 trunk with
    interleaved shared attention blocks), ``"ssm"`` (attention-free,
    rwkv6), ``"encdec"`` (encoder-decoder, whisper) and ``"vlm"``
    (decoder-only with a vision-prefix stub, llava-next: ``vision``).
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"                 # FFN activation (gated)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vision: Optional[VisionStubConfig] = None
    # multi-token-prediction depth (deepseek): 1 adds the MTP block and
    # its loss (weight 0.3) to lm_loss; serving never reads it
    mtp_depth: int = 0
    # numerics / memory policy
    dtype: str = "bfloat16"           # activation/param compute dtype
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"  # AdamW moments (optim.adamw.init)
    remat: str = "full"               # "none" | "full": recompute each block
    loss_chunk: int = 2048            # sequence chunk of the CE loss
    # KV chunk of the reference's online-softmax attention (the port's
    # flash kernel tiles itself; kept so configurations read the same)
    attn_chunk: int = 1024
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Training-driver configuration (the reference's ``TrainConfig``).

    ``donate_state``: the train step updates the parameters and moments
    in place (the reference donates them to ``jit``).
    ``grad_compression``: only ``"none"``. The reference's train step
    never reads the field, and a one-card step has no data-parallel
    reduction to compress; the int8 error-feedback functions are
    ``optim.compression``."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    grad_accum: int = 1
    seed: int = 0
    # fault tolerance
    checkpoint_dir: str = "/tmp/repro_ckpt"
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    # distributed optimization
    grad_compression: str = "none"    # "none" only (see the docstring)
    donate_state: bool = True

    def __post_init__(self):
        if self.grad_compression != "none":
            raise NotImplementedError(
                f"grad_compression={self.grad_compression!r}: a one-card "
                "train step has no data-parallel reduction to compress, and "
                "the reference's train step never reads this field; the "
                "int8 error-feedback functions are optim.compression "
                "(init_error, quantize, dequantize, compressed_psum)")
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum={self.grad_accum} must be >= 1")
