"""Audiobox-aesthetics predictor in PyTorch: the model, the checkpoint
loader and the chunked scorer.

The port of ``ai_music_generation_tpu/eval/audiobox.py``, held to it on
the same weights (tests/test_torch_audiobox.py). The reference's whole
audio-quality metric is Meta's ``audio-aes`` CLI (4 axes: CE content
enjoyment, CU content usefulness, PC production complexity, PQ production
quality; ref: scripts/common/abc_to_midi_wav_and_aesthetics.py:323-355).
Its weights are not in the repository, so score parity is a weight-file
drop-in:

- :class:`AudioboxAesthetics`: the WavLM encoder (``eval/wavlm.py``) +
  per-axis heads: a learned softmax weighting over the L+1 hidden states,
  a masked mean pool over frames, an MLP head and a per-axis affine output
  de-normalization (``out_mean`` / ``out_std``, identity by default, not
  part of the checkpoint layout: JAX's converter maps no key onto them).
  Its ``state_dict()`` is the checkpoint layout: the encoder under
  ``wavlm.`` with HF ``WavLMModel`` names, the heads as ``proj_<AXIS>.{0,2}``
  and ``layer_weights_<AXIS>``.
- :func:`load_state_dict`: maps a torch WavLM / audiobox state dict (the
  spellings JAX's ``convert_torch_state_dict`` accepts) onto the model;
  unmapped keys are returned, never silently dropped; a shape mismatch
  raises.
- :class:`AesPredictor`: batched 10-second-chunk scoring producing the
  same JSONL rows as ``audio-aes`` (non-overlapping 10 s windows, the
  mean weighted by valid length), on the card unless the caller passes
  ``device="cpu"``. The forward runs in IEEE fp32 whatever the process's
  TF32 settings (cuDNN runs fp32 convolutions in TF32 by default).

The head shape of the released ``facebook/audiobox-aesthetics`` checkpoint
is an assumption (weighted layer sum -> mean pool -> Linear(d->256) ->
GELU -> Linear(256->1), per the paper), configurable via ``head_hidden``.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ai_music_generation_tpu_torch.eval.wavlm import (
    WavLMConfig, WavLMEncoder, _truncated, init_wavlm_weights,
)
from ai_music_generation_tpu_torch.utils.device import (
    ieee_fp32,
    resolve_device,
)

AXES = ("CE", "CU", "PC", "PQ")
SAMPLE_RATE = 16_000
CHUNK_SECONDS = 10.0


@dataclasses.dataclass(frozen=True)
class AudioboxConfig:
    wavlm: WavLMConfig = WavLMConfig()
    head_hidden: Tuple[int, ...] = (256,)
    axes: Tuple[str, ...] = AXES


def _frames_for_samples(cfg: WavLMConfig, n: torch.Tensor) -> torch.Tensor:
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = torch.div(n - k, s, rounding_mode="floor") + 1
    return n.clamp(min=0)


class AudioboxAesthetics(nn.Module):
    """wave [B, T] (+ valid-sample counts [B]) -> scores [B, n_axes]."""

    def __init__(self, config: AudioboxConfig):
        super().__init__()
        self.config = config
        self.wavlm = WavLMEncoder(config.wavlm)
        n_states = config.wavlm.num_layers + 1
        for axis in config.axes:
            self.register_parameter(f"layer_weights_{axis}",
                                    nn.Parameter(torch.zeros(n_states)))
            layers, width = [], config.wavlm.hidden_size
            for hidden in config.head_hidden:
                layers += [nn.Linear(width, hidden), nn.GELU()]
                width = hidden
            setattr(self, f"proj_{axis}",
                    nn.Sequential(*layers, nn.Linear(width, 1)))
        n_axes = len(config.axes)
        self.register_buffer("out_mean", torch.zeros(n_axes),
                             persistent=False)
        self.register_buffer("out_std", torch.ones(n_axes), persistent=False)

    def forward(self, wave: torch.Tensor,
                n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        B, T = wave.shape
        frames = cfg.wavlm.frames_for_samples(T)
        if n_valid is None:
            frame_mask = None
        else:
            nf = _frames_for_samples(cfg.wavlm, n_valid.to(wave.device))
            frame_mask = (torch.arange(frames, device=wave.device)[None, :]
                          < nf[:, None]).float()
        # the mask reaches the encoder too (zeroed padded frames + masked
        # attention, HF semantics), not only the pool
        _, hiddens = self.wavlm(wave, frame_mask)
        if frame_mask is None:
            frame_mask = torch.ones(B, frames, device=wave.device)
        denom = frame_mask.sum(-1, keepdim=True) + 1e-6

        outs = []
        for i, axis in enumerate(cfg.axes):
            w = torch.softmax(getattr(self, f"layer_weights_{axis}"), dim=0)
            feat = torch.einsum("l,lbfd->bfd", w, hiddens)
            pooled = (feat * frame_mask[..., None]).sum(1) / denom  # [B, D]
            y = getattr(self, f"proj_{axis}")(pooled)[:, 0]
            outs.append(y * self.out_std[i] + self.out_mean[i])
        return torch.stack(outs, dim=-1)


@torch.no_grad()
def init_audiobox_weights(model: AudioboxAesthetics,
                          generator: torch.Generator) -> AudioboxAesthetics:
    """The JAX package's init in place: the encoder as
    :func:`init_wavlm_weights`, the heads' ``Dense`` kernels lecun-normal,
    their biases and the layer weights 0. ``generator`` must be on the
    model's device."""
    init_wavlm_weights(model.wavlm, generator)
    for axis in model.config.axes:
        getattr(model, f"layer_weights_{axis}").zero_()
        for layer in getattr(model, f"proj_{axis}"):
            if isinstance(layer, nn.Linear):
                _truncated(layer.weight, layer.weight.shape[1], 1.0,
                           generator)
                layer.bias.zero_()
    return model


# ---------------------------------------------------------------- loader

# The checkpoint keys (after prefix stripping) of the encoder: the port's
# keys are these names (under ``wavlm.`` in the full predictor), in torch
# layouts, so no key is renamed or transposed. JAX's ``_ENC_MAP`` lists
# the same patterns, each with its Flax path.
_ENC_MAP = [
    r"feature_extractor\.conv_layers\.(\d+)\.conv\.weight",
    r"feature_extractor\.conv_layers\.(\d+)\.conv\.bias",
    r"feature_extractor\.conv_layers\.(\d+)\.layer_norm\.weight",
    r"feature_extractor\.conv_layers\.(\d+)\.layer_norm\.bias",
    r"feature_projection\.layer_norm\.weight",
    r"feature_projection\.layer_norm\.bias",
    r"feature_projection\.projection\.weight",
    r"feature_projection\.projection\.bias",
    r"encoder\.pos_conv_embed\.conv\.bias",
    r"encoder\.layer_norm\.weight",
    r"encoder\.layer_norm\.bias",
    r"encoder\.layers\.(\d+)\.attention\.(q|k|v|out)_proj\.weight",
    r"encoder\.layers\.(\d+)\.attention\.(q|k|v|out)_proj\.bias",
    r"encoder\.layers\.(\d+)\.attention\.gru_rel_pos_linear\.weight",
    r"encoder\.layers\.(\d+)\.attention\.gru_rel_pos_linear\.bias",
    r"encoder\.layers\.(\d+)\.attention\.gru_rel_pos_const",
    r"encoder\.layers\.(\d+)\.attention\.rel_attn_embed\.weight",
    r"encoder\.layers\.(\d+)\.layer_norm\.weight",
    r"encoder\.layers\.(\d+)\.layer_norm\.bias",
    r"encoder\.layers\.(\d+)\.final_layer_norm\.weight",
    r"encoder\.layers\.(\d+)\.final_layer_norm\.bias",
    r"encoder\.layers\.(\d+)\.feed_forward\.intermediate_dense\.weight",
    r"encoder\.layers\.(\d+)\.feed_forward\.intermediate_dense\.bias",
    r"encoder\.layers\.(\d+)\.feed_forward\.output_dense\.weight",
    r"encoder\.layers\.(\d+)\.feed_forward\.output_dense\.bias",
]

# Plausible released-checkpoint head-key spellings -> the port's key (the
# JAX package's table, its Flax paths replaced by the port's names).
HEAD_KEY_HINTS = [
    (r"(?:proj|head)[._]?(CE|CU|PC|PQ)\.(?:0|fc1|dense1)\.weight",
     r"proj_\1.0.weight"),
    (r"(?:proj|head)[._]?(CE|CU|PC|PQ)\.(?:0|fc1|dense1)\.bias",
     r"proj_\1.0.bias"),
    (r"(?:proj|head)[._]?(CE|CU|PC|PQ)\.(?:2|fc2|dense2|out)\.weight",
     r"proj_\1.2.weight"),
    (r"(?:proj|head)[._]?(CE|CU|PC|PQ)\.(?:2|fc2|dense2|out)\.bias",
     r"proj_\1.2.bias"),
    (r"layer_weights[._]?(CE|CU|PC|PQ)", r"layer_weights_\1"),
]

_PREFIXES = ("model.", "module.", "state_dict.", "wavlm.", "aes.")


def _strip_prefix(key: str) -> str:
    changed = True
    while changed:
        changed = False
        for p in _PREFIXES:
            if key.startswith(p):
                key = key[len(p):]
                changed = True
    return key


def _compose_weight_norm(sd: dict) -> dict:
    """Pre-compose pos-conv weight-norm g,v into a plain kernel.

    torch ``weight_norm(conv, dim=2)``: w = g · v / ||v|| with the norm over
    all dims except 2 (g: [1, 1, K], v: [O, I/g, K]). Both spellings:
    ``parametrizations.weight.original0/1`` and ``weight_g/weight_v``. The
    kernel is composed in numpy fp32 as the JAX package's converter
    composes it, so both packages load the same bits.
    """
    out = dict(sd)
    for base in {
        k.rsplit(".", 1)[0].replace(".parametrizations.weight", "")
        for k in sd
        if "pos_conv_embed" in k and ("original0" in k or "weight_g" in k)
    }:
        if f"{base}.parametrizations.weight.original0" in sd:
            g = out.pop(f"{base}.parametrizations.weight.original0")
            v = out.pop(f"{base}.parametrizations.weight.original1")
        else:
            g = out.pop(f"{base}.weight_g")
            v = out.pop(f"{base}.weight_v")
        g = np.asarray(g, np.float32)
        v = np.asarray(v, np.float32)
        norm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
        out[f"{base}.weight"] = torch.from_numpy(
            g * v / np.maximum(norm, 1e-12))
    return out


def load_state_dict(model: nn.Module, sd: dict) -> Tuple[list, list]:
    """Load a torch state dict into ``model`` (an :class:`AudioboxAesthetics`
    or a bare :class:`WavLMEncoder`), in place.

    Accepts HF ``WavLMModel`` layouts and audiobox-style full-predictor
    dicts, with the prefixes and head spellings the JAX package's
    ``convert_torch_state_dict`` accepts. Returns ``(loaded_keys,
    unmapped_keys)``: a key that matches no rule, or names a parameter the
    model lacks, is unmapped; a shape mismatch raises ``ValueError``.
    Parameters the dict does not name keep their values.
    """
    sd = {_strip_prefix(k): (v.detach().float().cpu() if torch.is_tensor(v)
                             else torch.tensor(np.asarray(v, np.float32)))
          for k, v in sd.items()}
    sd = _compose_weight_norm(sd)
    sd.pop("masked_spec_embed", None)

    own = model.state_dict()
    enc_prefix = "wavlm." if isinstance(model, AudioboxAesthetics) else ""
    rules = ([(r"encoder\.pos_conv_embed\.conv\.weight", None)]
             + [(pat, None) for pat in _ENC_MAP] + HEAD_KEY_HINTS)
    loaded, unmapped, new = [], [], {}
    for key, val in sd.items():
        placed = False
        for pat, repl in rules:
            m = re.fullmatch(pat, key)
            if not m:
                continue
            name = enc_prefix + key if repl is None else m.expand(repl)
            if name not in own:
                break
            if own[name].shape != val.shape:
                raise ValueError(f"{key} -> {name}: shape "
                                 f"{tuple(val.shape)} != "
                                 f"{tuple(own[name].shape)}")
            new[name] = val
            loaded.append(key)
            placed = True
            break
        if not placed:
            unmapped.append(key)
    with torch.no_grad():
        for name, val in new.items():
            own[name].copy_(val)
    return loaded, unmapped


def config_from_state_dict(sd: dict) -> AudioboxConfig:
    """Infer the encoder geometry from a (prefix-stripped) state dict.

    Readable from key names/shapes: hidden size, layer count, head count
    (gru_rel_pos_const), FFN width, conv stack dims/kernels, pos-conv
    kernel/groups, bucket count, feat_extract_norm ("layer" iff conv layer
    1+ has a layer_norm). NOT inferable: do_stable_layer_norm (pre vs post
    norm use identical parameters) — defaults to False (WavLM base);
    override by constructing AudioboxConfig explicitly for a Large-style
    checkpoint. Strides/max_distance keep WavLM defaults.
    """
    sd = {_strip_prefix(k): v for k, v in sd.items()}
    proj = sd["feature_projection.projection.weight"]
    hidden, conv_last = proj.shape
    n_layers = 1 + max(
        int(m.group(1)) for k in sd
        if (m := re.match(r"encoder\.layers\.(\d+)\.", k)))
    heads = sd["encoder.layers.0.attention.gru_rel_pos_const"].shape[1]
    ffn = sd["encoder.layers.0.feed_forward.intermediate_dense.weight"].shape[0]
    buckets = sd["encoder.layers.0.attention.rel_attn_embed.weight"].shape[0]
    conv_dim, conv_kernel = [], []
    i = 0
    while f"feature_extractor.conv_layers.{i}.conv.weight" in sd:
        w = sd[f"feature_extractor.conv_layers.{i}.conv.weight"]
        conv_dim.append(w.shape[0])
        conv_kernel.append(w.shape[2])
        i += 1
    norm_mode = ("layer"
                 if "feature_extractor.conv_layers.1.layer_norm.weight" in sd
                 else "group")
    stride = tuple(WavLMConfig().conv_stride[:len(conv_dim)])
    pos_key = next((k for k in (
        "encoder.pos_conv_embed.conv.parametrizations.weight.original1",
        "encoder.pos_conv_embed.conv.weight_v",
        "encoder.pos_conv_embed.conv.weight") if k in sd), None)
    if pos_key is not None:
        pw = sd[pos_key]
        pos_k = pw.shape[2]
        pos_groups = hidden // pw.shape[1]
    else:
        pos_k, pos_groups = 128, 16
    return AudioboxConfig(wavlm=WavLMConfig(
        hidden_size=int(hidden), num_layers=int(n_layers),
        num_heads=int(heads), intermediate_size=int(ffn),
        conv_dim=tuple(int(c) for c in conv_dim),
        conv_kernel=tuple(int(k) for k in conv_kernel),
        conv_stride=stride,
        conv_bias="feature_extractor.conv_layers.0.conv.bias" in sd,
        feat_extract_norm=norm_mode,
        num_conv_pos_embeddings=int(pos_k),
        num_conv_pos_embedding_groups=int(pos_groups),
        num_buckets=int(buckets),
    ))


def load_torch_checkpoint(path: str) -> dict:
    """torch.load a checkpoint file (on the CPU) and unwrap common
    containers; tensors stay tensors."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return {k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            for k, v in obj.items()}


# ---------------------------------------------------------------- inference


class AesPredictor:
    """Chunked batched scoring with one canonical [batch, chunk] shape.

    ``weights``: path to a torch checkpoint (loaded through
    :func:`load_state_dict`; its geometry read by
    :func:`config_from_state_dict` unless ``config`` is given) or a ready
    state dict in the checkpoint layout; None = the JAX package's random
    init from ``generator`` (seed 0 when None; tests and smoke runs only:
    the scores are meaningless but the full compute path runs). Keys the
    loader could not place are kept in ``unmapped``. The model is built on
    the CPU, then moved to ``device``.
    """

    def __init__(self, config: Optional[AudioboxConfig] = None,
                 weights=None, batch: int = 8,
                 chunk_seconds: float = CHUNK_SECONDS, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        sd = None
        if isinstance(weights, str):
            sd = load_torch_checkpoint(weights)
            if config is None:  # geometry auto-detected from the checkpoint
                config = config_from_state_dict(sd)
        elif weights is not None:
            sd = weights
        self.config = config or AudioboxConfig()
        model = AudioboxAesthetics(self.config)
        init_audiobox_weights(
            model, generator or torch.Generator().manual_seed(0))
        self.unmapped: list = []
        if sd is not None:
            _, self.unmapped = load_state_dict(model, sd)
        self.model = model.to(self.device).eval()
        self.batch = batch
        # chunk_seconds < CHUNK_SECONDS deviates from the audio-aes windowing
        # protocol: tests only (attention is quadratic in frames)
        self.chunk_len = int(chunk_seconds * SAMPLE_RATE)

    @torch.inference_mode()
    def score_block(self, wave: np.ndarray,
                    n_valid: np.ndarray) -> np.ndarray:
        """One [batch, chunk] block of float32 samples and its valid counts
        -> [batch, n_axes] scores (host arrays)."""
        with ieee_fp32():
            out = self.model(torch.from_numpy(wave).to(self.device),
                             torch.from_numpy(n_valid).to(self.device))
        return out.cpu().numpy()

    def score_wave(self, wave: np.ndarray,
                   sample_rate: int = SAMPLE_RATE) -> dict:
        return self.score_waves([(wave, sample_rate)])[0]

    def score_waves(self, waves) -> list:
        """[(wave, rate), ...] -> [{axis: float}, ...].

        All files' 10 s chunks are packed into shared canonical-shape
        batches; per-file scores are chunk means weighted by valid length
        (the audio-aes windowing protocol).
        """
        chunks, n_valid, owner = [], [], []
        for fi, (wave, rate) in enumerate(waves):
            w = _to_mono_16k(wave, rate)
            if len(w) == 0:
                w = np.zeros(160, np.float32)
            for s in range(0, len(w), self.chunk_len):
                piece = w[s:s + self.chunk_len]
                if len(piece) < SAMPLE_RATE // 10 and s > 0:
                    continue  # <0.1 s trailing sliver: covered by prior chunk
                n_valid.append(len(piece))
                if len(piece) < self.chunk_len:
                    piece = np.pad(piece, (0, self.chunk_len - len(piece)))
                chunks.append(piece)
                owner.append(fi)

        per_chunk = np.zeros((len(chunks), len(self.config.axes)), np.float32)
        for s in range(0, len(chunks), self.batch):
            blk = chunks[s:s + self.batch]
            nv = n_valid[s:s + self.batch]
            pad = self.batch - len(blk)
            arr = np.stack(blk + [np.zeros(self.chunk_len, np.float32)] * pad)
            nva = np.asarray(nv + [self.chunk_len] * pad, np.int32)
            per_chunk[s:s + len(blk)] = self.score_block(arr, nva)[: len(blk)]

        results = []
        for fi in range(len(waves)):
            idx = [i for i, o in enumerate(owner) if o == fi]
            wts = np.asarray([n_valid[i] for i in idx], np.float32)
            sc = (per_chunk[idx] * wts[:, None]).sum(0) / wts.sum()
            results.append(
                {a: float(v) for a, v in zip(self.config.axes, sc)})
        return results

    def score_paths(self, paths) -> list:
        """[wav path, ...] -> [{axis: float}, ...] with a NaN row per
        unreadable/unscorable file — the single implementation of the
        audio-aes per-file contract shared by :meth:`score_jsonl` and the
        drop-in CLI (cli/audio_aes.py). Files are scored together so their
        chunks pack into shared canonical-shape device batches."""
        from ai_music_generation_tpu_torch.synth.wav_io import read_wav

        nan_row = {a: float("nan") for a in self.config.axes}
        waves, ok = [], []
        for p in paths:
            try:
                wave, rate = read_wav(p)
                waves.append((np.asarray(wave), rate))
                ok.append(True)
            except Exception:
                ok.append(False)
        try:
            scored = iter(self.score_waves(waves)) if waves else iter([])
            return [next(scored) if good else dict(nan_row) for good in ok]
        except Exception:
            return [dict(nan_row) for _ in paths]

    def score_jsonl(self, input_jsonl: str, output_jsonl: str) -> None:
        """Same contract as the audio-aes CLI (ref :323-325): each input
        line ``{"path": wav}`` becomes one output line of axis scores."""
        with open(input_jsonl) as f:
            paths = [json.loads(ln)["path"] for ln in f if ln.strip()]
        with open(output_jsonl, "w") as out:
            for s in range(0, len(paths), max(self.batch, 1)):
                for scores in self.score_paths(paths[s:s + max(self.batch, 1)]):
                    out.write(json.dumps(scores) + "\n")


def _to_mono_16k(wave: np.ndarray, rate: int) -> np.ndarray:
    w = np.asarray(wave, np.float32)
    if w.ndim == 2:
        w = w.mean(axis=-1 if w.shape[-1] <= 8 else 0)
    if rate != SAMPLE_RATE and len(w):
        n_out = max(1, int(round(len(w) * SAMPLE_RATE / rate)))
        x_out = np.arange(n_out, dtype=np.float64) * (rate / SAMPLE_RATE)
        w = np.interp(x_out, np.arange(len(w), dtype=np.float64), w)
    return w.astype(np.float32)
