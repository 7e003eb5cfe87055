"""Text-to-speech, VITS/piper-class (port of ``rten_tpu/models/tts.py``):
phoneme encoder → duration-regulated frames → mel decoder with a conv
post-net → a vocoder of two transposed 1-D convs.

Length regulation keeps the reference's fixed-shape form: durations →
cumulative ends → each frame of a static budget takes the first phoneme
whose end exceeds it, frames past the total masked. The encoder's rotary
embedding is the port's ``_rope_tables`` / ``_rope`` (theta 10000); its
GELU is the tanh approximation (``jax.nn.gelu``'s default). The vocoder's
convs are the reference's ``lhs_dilation`` correlations, not flipped
(:func:`~rten_tpu_torch.models.sam.conv_lhs_dilated`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.common import full_f32
from .bert import layer_norm
from .convert import params_from_numpy
from .sam import _div, conv_lhs_dilated
from .transformer import _rope, _rope_tables


@dataclass(frozen=True)
class TTSConfig:
    vocab_size: int = 256          # phoneme inventory
    d_model: int = 192
    n_layers: int = 4
    n_heads: int = 2
    d_ff: int = 768
    n_mels: int = 80
    max_phonemes: int = 256
    max_frames: int = 512          # static frame budget (masked beyond)
    hop: int = 64                  # vocoder upsampling (samples a frame)
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny_test(**kw):
        return TTSConfig(**{**dict(vocab_size=32, d_model=32, n_layers=2,
                                   n_heads=2, d_ff=64, n_mels=8,
                                   max_phonemes=16, max_frames=32, hop=16),
                            **kw})


class TextToSpeech:
    def __init__(self, config: TTSConfig = TTSConfig()):
        self.config = config

    def init_params(self, seed=0, device="cuda") -> dict:
        """Random demo weights in the reference's numpy ``RandomState``
        order (tts.py:57-90): seed 0 gives the JAX package's
        ``init_params`` exactly (float64 products rounded to f32 where
        the reference's are)."""
        cfg = self.config
        rng = np.random.RandomState(seed)
        d, dff = cfg.d_model, cfg.d_ff

        def dense(*shape):
            return (rng.randn(*shape)
                    / np.sqrt(shape[0])).astype(np.float32)

        params = {
            "embed": (dense(cfg.vocab_size, d) * np.sqrt(d)).astype(
                np.float32),
            "dur_w": dense(d, 1), "dur_b": np.zeros(1, np.float32),
            "mel_w": dense(d, cfg.n_mels),
            "mel_b": np.zeros(cfg.n_mels, np.float32),
            "post1.w": dense(5 * cfg.n_mels, cfg.n_mels).reshape(
                cfg.n_mels, cfg.n_mels, 5),
            "post1.b": np.zeros(cfg.n_mels, np.float32),
            "layers": [],
        }
        up = int(np.sqrt(cfg.hop))
        if up * up != cfg.hop:
            raise ValueError("hop must be a square (two-stage vocoder)")
        ch = 32
        params["voc1.w"] = dense(2 * up * cfg.n_mels, ch).reshape(
            cfg.n_mels, ch, 2 * up)
        params["voc1.b"] = np.zeros(ch, np.float32)
        params["voc2.w"] = dense(2 * up * ch, 1).reshape(ch, 1, 2 * up)
        params["voc2.b"] = np.zeros(1, np.float32)
        for _ in range(cfg.n_layers):
            params["layers"].append({
                "ln1_scale": np.ones(d, np.float32),
                "ln1_bias": np.zeros(d, np.float32),
                "wqkv": dense(d, 3 * d), "wo": dense(d, d),
                "ln2_scale": np.ones(d, np.float32),
                "ln2_bias": np.zeros(d, np.float32),
                "w_up": dense(d, dff), "w_down": dense(dff, d),
            })
        return params_from_numpy(params, device)

    def _ln(self, x, scale, bias):
        return layer_norm(x, scale, bias, self.config.layer_norm_eps)

    def encode(self, params, phonemes, lengths):
        """phonemes [B, P] ids, lengths [B] → hidden [B, P, d] (zero past
        each length)."""
        cfg = self.config
        b, p = phonemes.shape
        h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
        dev = params["embed"].device
        x = params["embed"][phonemes.to(torch.int64)]
        positions = torch.arange(p, device=dev)[None].expand(b, p)
        mask = torch.arange(p, device=dev)[None] < lengths.to(dev)[:, None]
        rope = _rope_tables(positions, hd, 10000.0)
        with full_f32():
            for layer in params["layers"]:
                y = self._ln(x, layer["ln1_scale"], layer["ln1_bias"])
                qkv = (y @ layer["wqkv"]).reshape(b, p, h, 3 * hd)
                q, k, v = (t.transpose(1, 2) for t in qkv.split(hd, dim=-1))
                q, k = _rope(q, *rope), _rope(k, *rope)
                s = _div(torch.einsum("bhqd,bhkd->bhqk", q, k),
                         float(np.sqrt(hd)))
                s = s.masked_fill(~mask[:, None, None, :], -1e30)
                o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
                x = x + o.transpose(1, 2).reshape(b, p, -1) @ layer["wo"]
                y = self._ln(x, layer["ln2_scale"], layer["ln2_bias"])
                x = x + F.gelu(y @ layer["w_up"],
                               approximate="tanh") @ layer["w_down"]
        return x * mask[..., None]

    def length_regulate(self, hidden, durations, lengths):
        """Repeat each phoneme's hidden vector for its duration, as a
        static-shape gather: frame t takes the first phoneme whose
        cumulative duration exceeds t. Returns (frames [B, T, d],
        frame_mask [B, T], n_frames int32 [B])."""
        cfg = self.config
        b, p, d = hidden.shape
        dev = hidden.device
        pmask = torch.arange(p, device=dev)[None] < lengths.to(dev)[:, None]
        durations = torch.where(pmask, durations.to(dev), 0)
        ends = torch.cumsum(durations, dim=1)                  # [B, P]
        n_frames = torch.clamp(ends[:, -1], max=cfg.max_frames).to(
            torch.int32)
        t = torch.arange(cfg.max_frames, device=dev)[None]     # [1, T]
        idx = (ends[:, None, :] <= t[:, :, None]).to(torch.int64).sum(-1)
        idx = torch.clamp(idx, max=p - 1)
        frames = torch.gather(hidden, 1, idx[..., None].expand(-1, -1, d))
        fmask = t < n_frames[:, None]
        return frames * fmask[..., None], fmask, n_frames

    def mel(self, params, frames, fmask):
        """frames [B, T, d] → mel [B, T, n_mels] with the conv post-net."""
        with full_f32():
            m = frames @ params["mel_w"] + params["mel_b"]
            # The conv reads post1.w with its first two axes swapped (the
            # reference's "OIH" view), padding 2.
            x = F.conv1d(m.transpose(1, 2),
                         params["post1.w"].transpose(0, 1), None, 1, 2)
            x = x + params["post1.b"].reshape(1, -1, 1)
            return (m + torch.tanh(x.transpose(1, 2))) * fmask[..., None]

    def vocode(self, params, mel):
        """mel [B, T, n_mels] → waveform [B, T*hop] through two transposed
        convs (lhs dilation by sqrt(hop) each)."""
        up = int(np.sqrt(self.config.hop))

        def tconv(x, w, bias, stride):
            # Output length T*stride needs pad_lo + pad_hi = k + stride - 2.
            total = w.shape[-1] + stride - 2
            out = conv_lhs_dilated(x, w, stride,
                                   [(total // 2, total - total // 2)])
            return out + bias.reshape(1, -1, 1)

        with full_f32():
            x = mel.transpose(1, 2)                            # [B, M, T]
            x = F.leaky_relu(tconv(x, params["voc1.w"], params["voc1.b"],
                                   up), 0.1)
            x = tconv(x, params["voc2.w"], params["voc2.b"], up)
            return torch.tanh(x[:, 0])

    def durations(self, params, hidden, pace=1.0):
        """Frames a phoneme: round(exp(clip(log_dur, -3, 3)) * pace), at
        least 1 (tts.py:183-186; a step function of the encoder's
        output)."""
        with full_f32():
            log_dur = (hidden @ params["dur_w"] + params["dur_b"])[..., 0]
        dur = torch.round(torch.exp(torch.clamp(log_dur, -3, 3)) * pace)
        return torch.clamp(dur.to(torch.int32), min=1)

    def synthesize(self, params, phonemes, lengths, pace=1.0):
        """Phoneme ids → waveform. Returns (wave [B, T*hop], n_samples
        [B])."""
        hidden = self.encode(params, phonemes, lengths)
        frames, fmask, n_frames = self.length_regulate(
            hidden, self.durations(params, hidden, pace), lengths)
        wave = self.vocode(params, self.mel(params, frames, fmask))
        return wave, n_frames * self.config.hop
