"""Config system (twin of ``src/repro/configs/base.py``): the fields the
training and serving paths of the dense, MoE, SSM (Mamba2 and RWKV-6),
hybrid (Zamba2) and vlm (llama-3.2-vision) LMs and of the encoder-decoder
(seamless-m4t) read, the federated cohort's included."""
from __future__ import annotations

import dataclasses

from repro_torch.comm.faults import FaultConfig
from repro_torch.comm.gossip import GossipConfig
from repro_torch.comm.overlap import OverlapConfig
from repro_torch.core.armijo import ArmijoConfig
from repro_torch.core.compression import Compressor
from repro_torch.core.gamma import GammaControllerConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0             # per-expert hidden size
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # serving under a mesh: True routes each data rank's tokens alone
    # (JAX's expert-parallel shard_map manualizes the batch), False over
    # the global batch (JAX's partitioner); one device: no effect
    moe_expert_parallel: bool = False
    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0    # >0: tied attn block every k ssm layers
    # --- enc-dec ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # --- VLM ---
    cross_attn_every: int = 0     # >0: one cross-attn layer per k self layers
    n_patches: int = 0
    rwkv_lora_rank: int = 64
    sliding_window: int = 0       # 0 = full attention
    # "int8": the self-attention KV caches hold int8 codes with f32
    # absmax scales per (position, head); any other string is the compute
    # dtype, as in JAX
    kv_cache_dtype: str = ""      # "" = compute dtype | "int8"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attn_chunk: int = 1024        # query-chunked attention above this seq len
    # rematerialise each of JAX's jax.checkpoint units (a layer; a hybrid
    # or vlm group) in the backward pass: memory, never values
    remat: bool = True
    # JAX: "flip on real TPU".  In the port: take the hand-written CUDA
    # kernels (flash attention, RMSNorm, WKV) for CUDA tensors; False
    # computes what the JAX package's jnp path computes on any device.
    use_pallas: bool = False
    citation: str = ""

    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm", "hybrid", "encdec",
                               "vlm"):
            raise ValueError(f"model family {self.family!r} of "
                             f"{self.name!r} is not ported (the port has "
                             "'dense', 'moe', 'ssm', 'hybrid', 'encdec' "
                             "and 'vlm')")
        if self.family == "vlm" and (
                self.cross_attn_every < 1
                or self.n_layers % self.cross_attn_every):
            # JAX's reshape of the stacked layers to (groups, every, ...)
            # fails there
            raise ValueError(
                f"vlm {self.name!r}: cross_attn_every="
                f"{self.cross_attn_every} must be >= 1 and divide "
                f"n_layers={self.n_layers} (the self layers stack as "
                "(groups, cross_attn_every, ...))")

    def check_mesh(self, model: int, data: int = 1,
                   batch: int | None = None) -> None:
        """Raise ``ValueError`` where a mesh of ``model`` x ``data`` ranks
        cannot serve this config: a family not cut over the model axis
        yet, a dim the model axis cuts that does not divide (JAX would
        cut mid-head; the port takes whole heads, experts and rows), or
        a batch of ``batch`` rows that the data axis does not divide."""
        if model > 1 and self.family not in ("dense", "moe"):
            raise ValueError(
                f"{self.name!r} ({self.family}): a model axis of {model} "
                "serves the dense and MoE families only; the others wait "
                "for ROADMAP queue 1 item 6c (the remaining families under "
                "a model axis)")
        if model > 1:
            cut = dict(n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
                       d_model=self.d_model, padded_vocab=self.padded_vocab)
            if self.family == "moe":
                cut["n_experts"] = self.n_experts
            else:
                cut["d_ff"] = self.d_ff
            for name, n in cut.items():
                if n % model:
                    raise ValueError(
                        f"{self.name!r}: {name}={n} does not divide over a "
                        f"model axis of {model}")
        if batch is not None and batch % data:
            raise ValueError(f"batch {batch} does not divide over a data "
                             f"axis of {data}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 256 multiple; padded logits are masked."""
        return -(-self.vocab_size // 256) * 256


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    seq_len: int
    global_batch: int


#: the optimizer kinds of the JAX trainer's plain path
KINDS = ("csgd_asss", "nonadaptive", "acgd", "sgd", "sls", "dense")
#: kinds that compress with error feedback (EF memory, packed exchange)
COMPRESSING = ("csgd_asss", "nonadaptive", "acgd")
#: kinds the overlap and gossip transports take (JAX's build_train_step)
OVERLAP_KINDS = GOSSIP_KINDS = ("csgd_asss", "nonadaptive")
#: kinds whose round takes ``local_steps`` > 1 (JAX's worker_fn dispatches
#: only these to ``_local_steps_worker``; acgd refuses local steps)
LOCAL_STEP_KINDS = ("csgd_asss", "nonadaptive")
#: kinds that run the Armijo search
SEARCHING = ("csgd_asss", "sls")
#: kinds the federated cohort takes (JAX's build_train_step)
FED_KINDS = ("csgd_asss", "nonadaptive")
#: EF memory dtypes of the trainer
EF_DTYPES = ("float32", "bfloat16")
#: fields of JAX paths the port lacks: (the only value taken, the feature)
NOT_PORTED = {
    "shard_local_topk": (False, "shard-local top-k under a model mesh "
                         "(ROADMAP queue 1 item 6b: the trainer's model "
                         "axis)")}


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    """Federated cohort simulation (DESIGN.md §13, ``repro_torch/fed/``).

    ``n_clients`` > 0 turns the train step into a cohort round: each
    data-parallel worker runs ``n_clients / W`` simulated clients (each
    with its own EF memory, gamma controller and Armijo step, in
    ``TrainState.fed``) through the compressed exchange, ONE all_gather
    and ONE all-reduce for the whole cohort.  Participation is sampled
    on the host each round (``fed/sampling.py``) and enters the step
    beside the batch as the ``"participation"`` mask.
    """

    n_clients: int = 0            # 0 = disabled (plain dp training)
    clients_per_round: int = 0    # fixed sampler: 0 -> all clients
    sampling: str = "fixed"       # fixed | bernoulli
    participation_rate: float = 1.0   # bernoulli per-client probability
    straggler_rate: float = 0.0   # drop each selected client with this p
    # "support" divides each coordinate by its nonzero-support count
    # across participants; "mean" keeps the zero-averaging dense mean
    # as the reference (fed/aggregate.py)
    aggregation: str = "support"
    # per-client gamma controllers (fixed | linear schedules; the linear
    # ramp advances on each client's OWN participation counter)
    per_client_gamma: bool = True
    dirichlet_alpha: float = 0.0  # >0: non-IID client data skew
    seed: int = 0                 # sampling stream seed

    @property
    def enabled(self) -> bool:
        return self.n_clients > 0

    def __post_init__(self):
        # JAX's checks, word for word
        from repro_torch.fed.aggregate import validate_aggregation
        from repro_torch.fed.sampling import validate_sampler
        validate_sampler(self.sampling)
        validate_aggregation(self.aggregation)
        if self.n_clients < 0:
            raise ValueError(f"n_clients must be >= 0, got {self.n_clients}")
        if not 0 <= self.clients_per_round <= self.n_clients:
            raise ValueError(
                f"clients_per_round={self.clients_per_round} out of range "
                f"for n_clients={self.n_clients}")
        if not 0.0 <= self.participation_rate <= 1.0:
            raise ValueError(f"participation_rate must be in [0, 1], got "
                             f"{self.participation_rate}")
        if not 0.0 <= self.straggler_rate < 1.0:
            raise ValueError(f"straggler_rate must be in [0, 1), got "
                             f"{self.straggler_rate}")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The data-parallel trainer's optimizer: ``csgd_asss`` (the paper's
    DCSGD-ASSS), ``nonadaptive`` (the same EF compression at a constant
    step ``eta``), ``acgd`` (the same at ``eta`` on the Nesterov
    direction ``momentum·v' + g``, core/acgd.py), ``sls`` (the Armijo
    search with a dense exchange), ``sgd`` and ``dense`` (one path: a
    dense exchange at ``eta``)."""

    kind: str = "csgd_asss"
    armijo: ArmijoConfig = ArmijoConfig()
    compressor: Compressor = Compressor()
    # per-round compression level (core/gamma.py); the schedule moves
    # gamma_t when compressor.max_gamma > 0 sizes the ragged wire budget
    gamma_controller: GammaControllerConfig = GammaControllerConfig()
    eta: float = 0.1              # the step of nonadaptive, acgd, sgd, dense
    # acgd: Nesterov mu (arXiv 2002.11364); like JAX's trainer config,
    # no band is checked here (core/acgd.AcgdConfig checks [0, 1))
    momentum: float = 0.9
    # exchange schedule, validated against the comm.transport registry:
    # "bucketed" (one flat all_gather a step), "perleaf" (the reference,
    # one all_gather a leaf), "overlap" (the bucketed schedule over a
    # chunked ring, shipping the previous step's payload at delay 1) or
    # "gossip" (the payload sent to a topology's neighbours only, each
    # worker mixing itself with them)
    transport: str = "bucketed"
    # overlap ring/staleness knobs; only read when transport="overlap"
    overlap: OverlapConfig = OverlapConfig()
    # gossip/consensus hyper-parameters; only read when transport="gossip"
    gossip: GossipConfig = GossipConfig()
    # circuit breaker: a non-finite round (loss or decoded update) skips
    # the parameter write with all carried optimizer state frozen; this
    # many CONSECUTIVE skips raise DivergenceError on the host
    # (core/health.py).  0 disables the gate: non-finite rounds write
    # through.
    max_consecutive_skips: int = 25
    # EF memory dtype: float32 or bfloat16 (each transport reads it as f32
    # and writes m' back with one rounding); JAX's int8 is refused
    ef_dtype: str = "float32"
    # local Armijo-SGD steps per exchange round (Qsparse-local-style, the
    # compressing kinds only; the other kinds ignore it, as JAX's do):
    # each takes one of ``microbatches == local_steps`` row groups
    local_steps: int = 1
    # return direction of the aggregate (comm/downlink.py): "dense" (the
    # f32 mean) or "compressed" (re-compressed through the same wire
    # format with the server's EF memory, no extra collective)
    downlink: str = "dense"
    # the downlink payload's ragged counts: fixed | linear only
    downlink_gamma: GammaControllerConfig = GammaControllerConfig()
    # hostile-wire robustness (DESIGN.md §16): a seeded fault-injection
    # campaign on the gathered payload rows (comm/faults.py).  All rates
    # 0 (the default) inject nothing; the decode verdicts and the
    # breaker stay armed either way
    faults: FaultConfig = FaultConfig()
    # federated cohort simulation (DESIGN.md §13): n_clients > 0 runs a
    # client cohort on each worker with per-client EF/gamma/alpha state
    # and support-weighted aggregation of the decoded top-k payloads
    federated: FederatedConfig = FederatedConfig()
    # the JAX package's, not ported: only the default is taken (a cohort
    # refuses it with JAX's own message, in RunConfig)
    shard_local_topk: bool = False

    def __post_init__(self):
        from repro_torch.comm.downlink import MODES as DOWNLINK_MODES
        from repro_torch.comm.transport import validate_transport
        validate_transport(self.transport)
        # JAX's OptimizerConfig checks (the downlink's, the breaker's and
        # the fault campaign's), then its build_train_step's for acgd and
        # the downlink, word for word (before the refusal of
        # shard_local_topk, so that downlink x shard_local_topk and
        # faults x shard_local_topk raise JAX's messages)
        if self.downlink not in DOWNLINK_MODES:
            raise ValueError(f"unknown downlink mode {self.downlink!r} "
                             f"(want one of {DOWNLINK_MODES})")
        if self.downlink == "compressed":
            if self.downlink_gamma.schedule not in ("fixed", "linear"):
                raise ValueError(
                    "downlink_gamma supports only the open-loop fixed | "
                    "linear schedules — the simulated server has no Armijo "
                    "search or per-worker EF telemetry to couple to "
                    f"(got {self.downlink_gamma.schedule!r})")
            if self.transport in ("gossip", "overlap"):
                raise ValueError(
                    "downlink='compressed' re-compresses a replicated "
                    "global aggregate; transport="
                    f"{self.transport!r} never materializes one "
                    "(gossip mixes neighbors, overlap applies stale "
                    "payloads — DESIGN.md §12/§14/§15)")
            if self.federated.enabled:
                raise ValueError(
                    "downlink='compressed' does not compose with the "
                    "federated cohort yet — the cohort's support-weighted "
                    "aggregate is produced inside the fed worker "
                    "(DESIGN.md §13), not by the §11 transport the "
                    "downlink hooks")
        if self.federated.enabled and self.transport == "gossip":
            raise ValueError(
                "federated cohort simulation does not compose with "
                "transport='gossip' — the cohort has its own one-gather "
                "collective schedule (DESIGN.md §13)")
        if self.federated.enabled and self.transport == "overlap":
            raise ValueError(
                "federated cohort simulation does not compose with "
                "transport='overlap' — the cohort gather carries per-client "
                "rows on its own schedule (DESIGN.md §13/§14)")
        if self.max_consecutive_skips < 0:
            raise ValueError(
                f"max_consecutive_skips must be >= 0 (0 disables the "
                f"breaker), got {self.max_consecutive_skips}")
        if self.faults.enabled:
            if self.kind not in COMPRESSING:
                raise ValueError(
                    f"fault injection corrupts the packed uplink wire "
                    f"(DESIGN.md §16); kind={self.kind!r} ships a dense "
                    f"pmean with no wire to corrupt — use csgd_asss | "
                    f"nonadaptive | acgd")
            if self.downlink == "compressed":
                raise ValueError(
                    "fault injection does not compose with "
                    "downlink='compressed' — the 'faulty' wrapper is a "
                    "stateful transport and the downlink hook requires a "
                    "stateless one (DESIGN.md §15/§16)")
            if self.shard_local_topk:
                raise ValueError(
                    "fault injection does not compose with "
                    "shard_local_topk — fault sites are keyed by whole-"
                    "gradient leaf index, not a model shard's lane set "
                    "(DESIGN.md §16)")
        # then JAX's build_train_step checks
        if self.kind == "acgd" and self.local_steps > 1:
            raise ValueError(
                "kind='acgd' does not compose with local_steps > 1 — the "
                "Nesterov velocity advances once per exchange round, not per "
                "local Armijo step (use kind='csgd_asss' for local steps)")
        if self.downlink == "compressed":
            if self.kind not in COMPRESSING:
                raise ValueError(
                    f"downlink='compressed' re-compresses the compressed "
                    f"exchange's aggregate (DESIGN.md §15); "
                    f"kind={self.kind!r} ships a dense pmean with no "
                    f"server to simulate — use csgd_asss | nonadaptive | "
                    f"acgd")
            if self.shard_local_topk:
                raise ValueError(
                    "downlink='compressed' does not compose with "
                    "shard_local_topk — the server plan is the whole-gradient "
                    "bucket geometry, not a model shard's")
            if self.local_steps > 1:
                raise ValueError(
                    "downlink='compressed' does not compose with "
                    "local_steps > 1 yet — the local-steps exchange applies "
                    "the dense mean delta directly")
        if self.transport == "gossip":
            # JAX's build_train_step also refuses a mesh of several
            # data-parallel axes here; the port's group is one flat
            # data-parallel axis, so that refusal has no counterpart
            if self.kind not in GOSSIP_KINDS:
                raise ValueError(
                    f"transport 'gossip' needs a compressing optimizer "
                    f"(csgd_asss | nonadaptive), got kind={self.kind!r}")
            if self.local_steps > 1:
                raise ValueError(
                    "transport 'gossip' does not compose with "
                    "local_steps > 1")
            if self.shard_local_topk:
                raise ValueError(
                    "transport 'gossip' does not compose with "
                    "shard_local_topk")
        if self.transport == "overlap":
            if self.kind not in OVERLAP_KINDS:
                raise ValueError(
                    f"transport 'overlap' needs a compressing optimizer "
                    f"(csgd_asss | nonadaptive), got kind={self.kind!r}")
            if self.shard_local_topk:
                raise ValueError(
                    "transport 'overlap' does not compose with "
                    "shard_local_topk (the carried payload geometry is the "
                    "whole-gradient bucket plan, not a model-shard's)")
        for name, (default, feature) in NOT_PORTED.items():
            # a cohort refuses shard_local_topk with JAX's message, in
            # RunConfig after JAX's earlier build-time checks
            if name == "shard_local_topk" and self.federated.enabled:
                continue
            if getattr(self, name) != default:
                raise ValueError(f"{name}={getattr(self, name)!r}: "
                                 f"{feature} is not ported (the port takes "
                                 f"only {default!r})")
        if self.kind not in KINDS:
            raise ValueError(f"unknown optimizer kind {self.kind!r} "
                             f"(want one of {KINDS})")
        # the JAX trainer's own checks (build_train_step)
        if self.gamma_controller.schedule == "armijo-coupled" and \
                self.kind not in SEARCHING:
            raise ValueError(
                f"gamma schedule 'armijo-coupled' needs an Armijo-searching "
                f"optimizer (csgd_asss | sls), got kind={self.kind!r} — use "
                f"'fixed' or 'linear'")
        if self.gamma_controller.schedule == "ef-coupled" and \
                self.kind not in COMPRESSING:
            raise ValueError(
                f"gamma schedule 'ef-coupled' needs a compressing optimizer "
                f"(csgd_asss | nonadaptive | acgd) — only those produce the "
                f"CompressionTelemetry it couples to, got kind={self.kind!r}")
        if self.ef_dtype == "int8":
            raise ValueError(
                "ef_dtype='int8': the JAX trainer stores the residual into "
                "int8 memory with a float->int8 convert, which truncates "
                "every |residual| < 1 to 0 and so drops error feedback; it "
                "is not a quantized EF and is not ported — for int8 EF "
                "memory use single-node CSGD's quantized EF "
                "(core/csgd.py, CSGDConfig(ef_dtype='int8'): per-block "
                "absmax scales)")
        if self.ef_dtype not in EF_DTYPES:
            raise ValueError(f"unknown ef_dtype {self.ef_dtype!r} (want one "
                             f"of {EF_DTYPES})")
        if self.local_steps < 1:
            raise ValueError(
                f"local_steps must be >= 1, got {self.local_steps}")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    optimizer: OptimizerConfig = OptimizerConfig()
    microbatches: int = 1          # gradient accumulation per worker

    def __post_init__(self):
        if self.microbatches < 1:
            raise ValueError(
                f"microbatches must be >= 1, got {self.microbatches}")
        opt, micro = self.optimizer, self.microbatches
        # JAX's build-time contract (build_train_step), word for word
        if opt.local_steps > 1 and opt.kind in LOCAL_STEP_KINDS \
                and micro != opt.local_steps:
            raise ValueError(
                f"local_steps={opt.local_steps} requires microbatches == "
                f"local_steps (got microbatches={micro}): each local Armijo "
                f"step consumes exactly one microbatch of the global batch")
        # then its cohort checks that need no worker count (the rest:
        # check_cohort, when the state is built for W workers)
        if opt.federated.enabled:
            if opt.kind not in FED_KINDS:
                raise ValueError(
                    f"federated cohort simulation needs a compressing "
                    f"optimizer (csgd_asss | nonadaptive), got "
                    f"kind={opt.kind!r}")
            if opt.local_steps > 1:
                raise ValueError(
                    "federated cohort simulation does not compose with "
                    "local_steps > 1")
            if opt.shard_local_topk:
                raise ValueError(
                    "federated cohort simulation does not compose with "
                    "shard_local_topk")
            if micro > 1:
                raise ValueError(
                    "federated cohort simulation does not compose with "
                    "microbatches > 1 (each client IS a batch row group)")


def check_cohort(opt: OptimizerConfig, W: int) -> None:
    """JAX's last two cohort checks of ``build_train_step``, word for
    word, for a group of W workers (``launch.train_step.init_train_state``
    runs them)."""
    fed = opt.federated
    if not fed.enabled:
        return
    if fed.n_clients % W:
        raise ValueError(
            f"n_clients={fed.n_clients} must divide evenly over the "
            f"{W} dp workers (each worker vmaps n_clients/W clients)")
    if opt.gamma_controller.schedule not in ("fixed", "linear"):
        raise ValueError(
            f"per-client gamma controllers support the 'fixed' and "
            f"'linear' schedules (each client sees only its own "
            f"participation counter, not the coupled telemetry), got "
            f"{opt.gamma_controller.schedule!r}")


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests: 2 layers, d_model 128,
    query chunks of 64, LoRA rank 8 for RWKV, 4 experts top-2 of width 64
    at capacity factor 2 (E/k: C = T, drop-free) for MoE, SSM state 16
    and SSM heads of 32 for Mamba2, 5 layers with the shared block every
    2 for the hybrid, 2 encoder and 2 decoder layers for the
    encoder-decoder, 4 layers with a cross-attention block every 2 over
    16 patches for the vlm, no rematerialisation (JAX's
    ``smoke_variant`` less the fields the port does not read)."""
    kw = dict(n_layers=2, d_model=128, n_heads=4,
              n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
              d_ff=256, vocab_size=512, head_dim=32, param_dtype="float32",
              compute_dtype="float32", attn_chunk=64, remat=False)
    if cfg.family == "moe":
        kw.update(n_experts=4, experts_per_token=2, moe_d_ff=64,
                  capacity_factor=2.0)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=32)
    if cfg.family == "hybrid":
        kw.update(n_layers=5, shared_attn_every=2)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, n_dec_layers=2)
    if cfg.family == "vlm":
        kw.update(n_layers=4, cross_attn_every=2, n_patches=16)
    if cfg.name.startswith("rwkv"):
        kw.update(rwkv_lora_rank=8)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    return dataclasses.replace(cfg, **kw)
