"""WavLM audio encoder (the Audiobox-aesthetics SSL backbone) in PyTorch.

The port of ``ai_music_generation_tpu/eval/wavlm.py``: the same encoder,
held to the JAX package's and to ``transformers.WavLMModel`` on the same
weights (tests/test_torch_wavlm.py). The reference scores audio with
Meta's ``audio-aes`` CLI, whose predictor is a WavLM-style SSL encoder + 4
regression heads (ref: scripts/common/abc_to_midi_wav_and_aesthetics.py:
323-355; model per arXiv:2502.05139).

Architecture (inference path only: no SpecAugment, no quantizer):

1. **Feature encoder**: 1-D convs over raw 16 kHz audio (kernel
   10,3,3,3,3,2,2 / stride 5,2,2,2,2,2,2 -> 49.6 Hz frames);
   ``feat_extract_norm="group"`` (base): GroupNorm(C, C) after conv 0 only;
   ``"layer"`` (large): a LayerNorm over channels after every conv (eps
   1e-5). Exact GELU throughout.
2. **Feature projection**: LayerNorm -> Linear(conv_dim[-1] -> hidden).
3. **Positional conv embedding**: grouped Conv1d (kernel 128, groups 16;
   the checkpoint's weight norm is composed into one kernel on load), the
   last column dropped for an even kernel, GELU, residual add.
4. **Transformer** with WavLM's gated relative position bias: layer 0 owns
   a bucketed relative-position embedding (T5-style log buckets, 320
   buckets, max distance 800) that every layer reuses, gated per query
   position from the layer's own input. Post-norm (base) or pre-norm + a
   final LayerNorm (large).

Parameters carry the names of the HF ``WavLMModel`` checkpoint
(``feature_extractor.conv_layers.{i}.conv.weight``,
``encoder.layers.{i}.attention.gru_rel_pos_linear.weight``, ...), so a
module's ``state_dict()`` is the checkpoint layout itself. Everything is
fp32 (``WavLMConfig.dtype`` is float32 in the JAX package); the
predictor (``eval/audiobox.py``) keeps cuDNN and cuBLAS off TF32 around
its forward. The JAX package's fp32 ``_LayerNorm`` is ``nn.LayerNorm``
here: the model computes in fp32 throughout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" (base) | "layer" (large)
    do_stable_layer_norm: bool = False  # False = base (post-norm)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_distance: int = 800
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def frames_for_samples(self, n: int) -> int:
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        return n


class _ConvLayer(nn.Module):
    """One conv of the feature encoder and its norm (HF's
    ``WavLM{No,Group,Layer}NormConvLayer``)."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int, stride: int,
                 norm: Optional[str], config: WavLMConfig):
        super().__init__()
        self.conv = nn.Conv1d(in_dim, out_dim, kernel, stride,
                              bias=config.conv_bias)
        self.norm = norm
        if norm == "group":
            self.layer_norm = nn.GroupNorm(out_dim, out_dim,
                                           eps=config.layer_norm_eps)
        elif norm == "layer":
            self.layer_norm = nn.LayerNorm(out_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm == "group":
            # GroupNorm(C, C): each channel normalised over time
            x = self.layer_norm(x)
        elif self.norm == "layer":
            # LayerNorm over channels at each frame (a hard 1e-5, as JAX)
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        return F.gelu(x)


class FeatureEncoder(nn.Module):
    """Raw-audio conv stack: wave [B, T] -> [B, frames, C]."""

    def __init__(self, config: WavLMConfig):
        super().__init__()
        dims = (1,) + tuple(config.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s,
                       "layer" if config.feat_extract_norm == "layer"
                       else "group" if i == 0 else None, config)
            for i, (k, s) in enumerate(zip(config.conv_kernel,
                                           config.conv_stride)))

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        x = wave[:, None, :].float()
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """T5-style log-bucketed relative positions (HF
    ``WavLMAttention._relative_positions_bucket``, bidirectional), int64
    [Q, K] on the CPU, equal to the JAX package's table bit for bit (the
    log of a distance below ``max_exact`` is never taken: its lanes would be
    ``log(0) = -inf``, whose int cast is undefined, and ``where`` drops them
    in JAX)."""
    rel = torch.arange(k_len)[None, :] - torch.arange(q_len)[:, None]
    half = num_buckets // 2
    buckets = (rel > 0).to(torch.int64) * half
    rel = rel.abs()
    max_exact = half // 2
    is_small = rel < max_exact
    far = rel.clamp(min=max_exact).to(torch.float32)
    rel_if_large = (torch.log(far / max_exact)
                    / math.log(max_distance / max_exact)
                    * (half - max_exact))
    rel_if_large = torch.clamp(max_exact + rel_if_large.to(torch.int64),
                               max=half - 1)
    return buckets + torch.where(is_small, rel, rel_if_large)


class GatedRelPosAttention(nn.Module):
    """WavLM self-attention with a gated relative position bias.

    ``position_bias`` [H, T, T] is computed by layer 0 (which owns
    ``rel_attn_embed``) and passed to later layers; every layer applies its
    own query-conditioned gate gate_a * (gate_b * const - 1) + 2, per
    (batch, head, query position), computed from the layer's INPUT hidden
    states reshaped per head (not from q).
    """

    def __init__(self, config: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        D, H = config.hidden_size, config.num_heads
        self.config = config
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        self.gru_rel_pos_linear = nn.Linear(config.head_dim, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, H, 1, 1))
        if has_relative_position_bias:
            self.rel_attn_embed = nn.Embedding(config.num_buckets, H)
        self._buckets: dict = {}  # (T, device) -> the bucket table there

    def buckets(self, T: int) -> torch.Tensor:
        """The [T, T] bucket table on ``rel_attn_embed``'s device, built on
        the host once per (T, device)."""
        device = self.rel_attn_embed.weight.device
        key = (T, device)
        if key not in self._buckets:
            cfg = self.config
            self._buckets[key] = relative_position_buckets(
                T, T, cfg.num_buckets, cfg.max_distance).to(device)
        return self._buckets[key]

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor],
                key_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, T, D = x.shape
        H, hd = self.config.num_heads, self.config.head_dim
        if position_bias is None:
            position_bias = self.rel_attn_embed.weight[
                self.buckets(T)].permute(2, 0, 1)  # [H, T, T]

        q = self.q_proj(x).view(B, T, H, hd).transpose(1, 2)
        k = self.k_proj(x).view(B, T, H, hd).transpose(1, 2)
        v = self.v_proj(x).view(B, T, H, hd).transpose(1, 2)

        gate_in = x.view(B, T, H, hd).transpose(1, 2)  # [B, H, T, hd]
        proj = self.gru_rel_pos_linear(gate_in).view(B, H, T, 2, 4).sum(-1)
        gate = torch.sigmoid(proj)
        gate_a, gate_b = gate[..., 0:1], gate[..., 1:2]  # [B, H, T, 1]
        gate_out = gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0
        gated_bias = gate_out * position_bias[None]

        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        scores = scores + gated_bias
        if key_mask is not None:
            # HF adds (1 - mask) * finfo.min: attention never reaches padded
            # frames (the additive form, as JAX)
            scores = scores + ((1.0 - key_mask[:, None, None, :])
                               * torch.finfo(torch.float32).min)
        attn = torch.softmax(scores, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, D)
        return self.out_proj(out), position_bias


class EncoderLayer(nn.Module):
    def __init__(self, config: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        self.stable = config.do_stable_layer_norm
        self.attention = GatedRelPosAttention(config,
                                              has_relative_position_bias)
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       eps=config.layer_norm_eps)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size,
                                             eps=config.layer_norm_eps)
        self.feed_forward = nn.ModuleDict(dict(
            intermediate_dense=nn.Linear(config.hidden_size,
                                         config.intermediate_size),
            output_dense=nn.Linear(config.intermediate_size,
                                   config.hidden_size)))

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        ff = self.feed_forward
        return ff["output_dense"](F.gelu(ff["intermediate_dense"](x)))

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor],
                key_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.stable:  # pre-norm (large)
            a, position_bias = self.attention(self.layer_norm(x),
                                              position_bias, key_mask)
            x = x + a
            x = x + self._ffn(self.final_layer_norm(x))
        else:  # post-norm (base)
            a, position_bias = self.attention(x, position_bias, key_mask)
            x = self.layer_norm(x + a)
            x = self.final_layer_norm(x + self._ffn(x))
        return x, position_bias


class WavLMEncoder(nn.Module):
    """Full encoder: wave [B, T] -> (last_hidden, all_hidden [L+1, B, F, D]).

    ``all_hidden`` matches HF ``output_hidden_states=True`` ordering: entry
    i is the input to transformer layer i (after the pos-conv, and its
    LayerNorm for post-norm), entry L the final output: the features the
    aesthetics heads weight.
    """

    def __init__(self, config: WavLMConfig):
        super().__init__()
        self.config = config
        D, k = config.hidden_size, config.num_conv_pos_embeddings
        self.feature_extractor = FeatureEncoder(config)
        self.feature_projection = nn.ModuleDict(dict(
            layer_norm=nn.LayerNorm(config.conv_dim[-1],
                                    eps=config.layer_norm_eps),
            projection=nn.Linear(config.conv_dim[-1], D)))
        self.encoder = nn.ModuleDict(dict(
            pos_conv_embed=nn.ModuleDict(dict(conv=nn.Conv1d(
                D, D, k, padding=k // 2,
                groups=config.num_conv_pos_embedding_groups))),
            layer_norm=nn.LayerNorm(D, eps=config.layer_norm_eps),
            layers=nn.ModuleList(
                EncoderLayer(config, has_relative_position_bias=(i == 0))
                for i in range(config.num_layers))))

    def forward(self, wave: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``frame_mask``: optional [B, frames] 1.0/0.0 validity mask (HF
        ``attention_mask`` downsampled to frames). Padded frames are zeroed
        before the positional conv and excluded from attention, as HF
        masks them."""
        cfg, enc = self.config, self.encoder
        feats = self.feature_extractor(wave)
        fp = self.feature_projection
        x = fp["projection"](fp["layer_norm"](feats))
        if frame_mask is not None:
            x = x * frame_mask[..., None].to(x.dtype)

        pc = enc["pos_conv_embed"]["conv"](x.transpose(1, 2))
        if cfg.num_conv_pos_embeddings % 2 == 0:
            pc = pc[:, :, :-1]
        x = x + F.gelu(pc).transpose(1, 2)

        if not cfg.do_stable_layer_norm:
            x = enc["layer_norm"](x)

        hiddens = [x]
        position_bias = None
        for layer in enc["layers"]:
            x, position_bias = layer(x, position_bias, frame_mask)
            hiddens.append(x)

        if cfg.do_stable_layer_norm:
            x = enc["layer_norm"](x)
            hiddens[-1] = x

        return x, torch.stack(hiddens)


def _truncated(t: torch.Tensor, fan_in: int, scale: float,
               generator: torch.Generator) -> None:
    """Flax's ``variance_scaling(scale, "fan_in", "truncated_normal")``: a
    normal truncated at two standard deviations, its std corrected so the
    variance is ``scale / fan_in``."""
    std = math.sqrt(scale / fan_in) / .87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_wavlm_weights(model: WavLMEncoder,
                       generator: torch.Generator) -> WavLMEncoder:
    """The JAX package's init in place: he-normal conv kernels (fan-in by
    Flax's rule on the [O, I/g, K] array), lecun-normal ``Dense`` kernels
    (fan-in = in), ``rel_attn_embed`` N(0, 0.02), the positional conv
    N(0, 2 sqrt(1 / (K * D))), biases 0, norm scales 1,
    ``gru_rel_pos_const`` 1. ``generator`` must be on the model's device."""
    cfg = model.config
    for layer in model.feature_extractor.conv_layers:
        # Flax reads a kernel as [..., in, out]: the JAX package's [O, I/g,
        # K] conv kernel has fan-in I/g * O under that rule
        shape = layer.conv.weight.shape
        _truncated(layer.conv.weight, shape[0] * shape[1], 2.0, generator)
    pos = model.encoder["pos_conv_embed"]["conv"]
    pos.weight.normal_(0.0, 2.0 * math.sqrt(
        1.0 / (cfg.num_conv_pos_embeddings * cfg.hidden_size)),
        generator=generator)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            # torch's [out, in] weight: fan-in is its last dim, as Flax's
            # [in, out] kernel's first
            _truncated(module.weight, module.weight.shape[1], 1.0, generator)
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            module.weight.fill_(1.0)
        elif isinstance(module, GatedRelPosAttention):
            module.gru_rel_pos_const.fill_(1.0)
        if getattr(module, "bias", None) is not None:
            module.bias.zero_()
    return model
