"""Configuration of the PyTorch port: architectures, shapes, run settings.

The architecture configs (``ArchConfig`` and its sub-configs) and the
serving/training shape set (``SHAPES``, with ``shape_applicable`` and the
inputs' stand-ins ``input_specs``) are pure data, copied from the JAX
package's ``config.py`` so that both packages describe a model the same
way.  Three run settings follow: the panel-transport mode
(``REPRO_TRANSPORT``), the block-storage dtype of the dtype-matrixed test
runs (``REPRO_STORAGE_DTYPE``), both as in the JAX package, and the device
an entry point runs on.  The JAX package's
``pallas_interpret()`` has no twin: a kernel wrapper picks its plain
version or its CUDA kernel from the device of the tensors it is given.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace

import torch

# ---------------------------------------------------------------------------
# sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int | None = None  # defaults to arch d_ff
    layer_period: int = 1  # MoE every `period` layers (llama4/jamba: 2)
    capacity_factor: float = 1.25
    # "tp" (experts TP-sharded) | "ep" (expert parallel) | "dense" (exact
    # oracle) | "spgemm" (dispatch as block-sparse SpGEMM through
    # engine.multiply — the serving path, DESIGN.md §11)
    impl: str = "tp"
    # block-row size of the (token-block x expert) dispatch BSM the
    # "spgemm" impl builds (tokens per block; T is padded up to a multiple)
    token_block: int = 4


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 16  # sequential-scan chunk (remat granularity)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 16


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder; the conv/mel frontend is a stub — the model
    takes precomputed frame embeddings (B, n_frames, d_model)."""

    n_layers: int
    n_frames: int = 1500


# ---------------------------------------------------------------------------
# architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads
    qkv_bias: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    sliding_window: int | None = None
    window_pattern: int = 2  # local layer every `pattern` layers (gemma2)
    mlp: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    post_norm: bool = False  # gemma2 sandwich norms
    moe: MoEConfig | None = None
    mixer: str = "attention"  # attention | mamba_hybrid | rwkv6
    attn_layer_period: int = 8  # hybrid: attention every Nth layer
    mamba: MambaConfig | None = None
    rwkv: RWKVConfig | None = None
    encoder: EncoderConfig | None = None  # enc-dec (whisper)
    frontend: str | None = None  # audio | vision | None
    n_patches: int = 256  # vlm stub: image patches fused into the prefix
    rope: bool = True
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"  # bf16 for the 400B MoE (fits HBM)
    source: str = ""  # provenance note

    # ---- derived -------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_pattern_period(self) -> int:
        """Length of the repeating layer pattern (the scanned superblock)."""
        p = 1
        if self.moe is not None:
            p = _lcm(p, self.moe.layer_period)
        if self.sliding_window is not None:
            p = _lcm(p, self.window_pattern)
        if self.mixer == "mamba_hybrid":
            p = _lcm(p, self.attn_layer_period)
        return p

    def layer_kinds(self) -> list[dict]:
        """Per-position spec within one pattern period."""
        period = self.layer_pattern_period
        assert self.n_layers % period == 0, (self.name, self.n_layers, period)
        kinds = []
        for i in range(period):
            mixer = "attention"
            if self.mixer == "mamba_hybrid":
                mixer = "attention" if i % self.attn_layer_period == 0 else "mamba"
            elif self.mixer == "rwkv6":
                mixer = "rwkv6"
            window = None
            if self.sliding_window is not None and i % self.window_pattern == 0:
                window = self.sliding_window
            use_moe = self.moe is not None and (i % self.moe.layer_period
                                                == self.moe.layer_period - 1)
            kinds.append(dict(mixer=mixer, window=window, moe=use_moe))
        return kinds

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / linear attn)."""
        return self.mixer in ("mamba_hybrid", "rwkv6")

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and reporting)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd, h, hkv = self.hd, self.n_heads, self.n_kv_heads
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        kinds = self.layer_kinds()
        reps = self.n_layers // len(kinds)
        for k in kinds:
            p = 0
            if k["mixer"] == "attention":
                p += d * (h * hd) + 2 * d * (hkv * hd) + (h * hd) * d
                if self.qkv_bias:
                    p += h * hd + 2 * hkv * hd
            elif k["mixer"] == "mamba":
                m = self.mamba or MambaConfig()
                di = m.expand * d
                p += d * 2 * di + di * m.d_conv + di * (2 * m.d_state + 1)
                p += di * m.d_state + di + di * d  # dt/out projections
            elif k["mixer"] == "rwkv6":
                r = self.rwkv or RWKVConfig()
                p += 4 * d * d + d * r.decay_lora * 2 + 2 * d * ff  # time+channel mix
            if k["moe"]:
                moe = self.moe
                de = moe.d_expert or ff
                n_mats = 3 if self.mlp in ("swiglu", "geglu") else 2
                p += moe.n_experts * n_mats * d * de
                p += moe.n_shared * n_mats * d * de
                p += d * moe.n_experts  # router
            elif k["mixer"] != "rwkv6":  # rwkv channel-mix counted above
                n_mats = 3 if self.mlp in ("swiglu", "geglu") else 2
                p += n_mats * d * ff
            total += p * reps
        if self.encoder is not None:
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = (4 * d * d + 2 * d * ff) * self.encoder.n_layers
            xattn = 4 * d * d * self.n_layers
            total += enc + xattn
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        moe = self.moe
        de = moe.d_expert or self.d_ff
        n_mats = 3 if self.mlp in ("swiglu", "geglu") else 2
        kinds = self.layer_kinds()
        reps = self.n_layers // len(kinds)
        n_moe_layers = sum(1 for k in kinds if k["moe"]) * reps
        inactive = (moe.n_experts - moe.top_k) * n_mats * self.d_model * de
        return self.param_count() - n_moe_layers * inactive

    def reduced(self) -> "ArchConfig":
        """Small same-family variant for CPU smoke tests."""
        period = self.layer_pattern_period
        moe = self.moe
        if moe is not None:
            moe = replace(moe, n_experts=min(moe.n_experts, 8),
                          top_k=min(moe.top_k, 2), d_expert=128)
        enc = self.encoder
        if enc is not None:
            enc = replace(enc, n_layers=2, n_frames=16)
        hd = 32 if self.head_dim is not None else None
        return replace(
            self,
            n_layers=2 * period,  # two scanned repetitions of the pattern
            d_model=128,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=hd,
            d_ff=256,
            vocab=512,
            sliding_window=64 if self.sliding_window else None,
            moe=moe,
            mamba=replace(self.mamba, chunk=8) if self.mamba else None,
            rwkv=replace(self.rwkv, head_dim=32, chunk=8) if self.rwkv else None,
            encoder=enc,
            n_patches=8,
            dtype="float32",
        )


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)


# ---------------------------------------------------------------------------
# input shapes (the assigned shape set)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether this (arch, shape) cell runs; reason if skipped."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("full-attention architecture: 500k-token decode needs "
                       "sub-quadratic attention (DESIGN.md §Arch-applicability)")
    return True, ""


def input_specs(arch: ArchConfig, shape: ShapeConfig) -> dict:
    """Shape / dtype stand-ins (``sharding.Leaf``) for every model input,
    nothing allocated.  The reference's, except that token ids are int64
    (the port's index ops take int64, and its data stream gives it)."""
    from repro_torch.parallel.sharding import Leaf

    b, s = shape.global_batch, shape.seq_len
    dt = _TORCH_DTYPES[arch.dtype]
    specs = {}
    if shape.kind == "train":
        specs["tokens"] = Leaf((b, s), torch.int64)
        specs["targets"] = Leaf((b, s), torch.int64)
    elif shape.kind == "prefill":
        specs["tokens"] = Leaf((b, s), torch.int64)
    else:  # decode: one new token against a seq_len-deep cache/state
        specs["tokens"] = Leaf((b, 1), torch.int64)
        specs["position"] = Leaf((), torch.int64)
    if arch.frontend == "vision" and shape.kind != "decode":
        specs["patch_embeds"] = Leaf((b, arch.n_patches, arch.d_model), dt)
    if arch.encoder is not None and shape.kind != "decode":
        specs["frame_embeds"] = Leaf((b, arch.encoder.n_frames,
                                      arch.d_model), dt)
    return specs


# ---------------------------------------------------------------------------
# run settings
# ---------------------------------------------------------------------------


def transport_mode() -> str:
    """Configured panel-transport mode: "auto" | "dense" | "compressed".

    ``REPRO_TRANSPORT`` overrides (debugging / forcing a path): "dense"
    pins the full-panel hops, "compressed" forces occupancy-compressed
    packing, unset/"auto" lets the plan layer choose per pattern from the
    bucketed capacity fill (``core.transport.resolve_mode``).  Read where
    a multiply's ``transport=None`` is resolved
    (``plan.resolve_transport``)."""
    raw = os.environ.get("REPRO_TRANSPORT", "auto").strip().lower()
    if raw in ("", "auto"):
        return "auto"
    if raw in ("dense", "compressed"):
        return raw
    raise ValueError(
        f"REPRO_TRANSPORT={raw!r}: expected auto | dense | compressed"
    )


def storage_dtype() -> str:
    """Configured block-storage dtype for dtype-matrixed test/CI runs.

    ``REPRO_STORAGE_DTYPE`` selects the reduced-precision storage leg of
    the CI matrix: "float32" (default) keeps the exact path, "bfloat16"
    runs the mixed-precision path (bf16 blocks, f32 accumulation).  Read by
    the dtype-matrixed end-to-end tests; library code never consults it
    (storage dtype is an explicit argument: ``bsm.cast_bsm`` /
    ``sign_iteration(storage_dtype=...)``).
    """
    raw = os.environ.get("REPRO_STORAGE_DTYPE", "float32").strip().lower()
    if raw in ("", "f32", "float32"):
        return "float32"
    if raw in ("bf16", "bfloat16"):
        return "bfloat16"
    raise ValueError(
        f"REPRO_STORAGE_DTYPE={raw!r}: expected float32 | bfloat16"
    )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and no
    CUDA device is present — an entry point never moves to the CPU on its
    own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev
