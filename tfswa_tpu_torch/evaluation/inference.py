"""Full-track source separation with overlap-add (counterpart of
``tfswa_tpu/evaluation/inference.py``).

The per-segment pipeline is STFT -> model -> masks -> iSTFT on batches of
segments.  Two overlap-add paths:
  - device OLA (``device_ola=True``): the track is cut into fixed windows of
    ``ola_window_segments`` segments on a uniform grid; each window is one
    host-to-device copy, its segments run in batches, the Hann-weighted
    scatter runs on the device (``index_add_``) and one device-to-host copy
    brings the window back.  Every window is dispatched before any is
    fetched.  Normalisation by the analytic Hann envelope is on the host.
  - host OLA: the reference's loop with last-segment clamping.
Audio crosses the host-device boundary in ``transfer_dtype``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import EvalConfig, ModelConfig, STFTConfig
from ..models.tfswa_unet import TFSWAUNet
from ..ops.masking import (apply_direct_masks, apply_magnitude_masks,
                           trainer_masked_complex)
from ..ops.stft import STFTProcessor, SpectrogramNormalizer, get_window

# int16 transfer scaling: 4x headroom over full-scale audio.
_INT16_SCALE = 8192.0
_TRANSFER_DTYPES = ("float32", "float16", "int16")


def _hann(length: int) -> np.ndarray:
    """Periodic Hann, as torch.hann_window."""
    return get_window("hann", length).astype(np.float32)


class SourceSeparator:
    """Separation of a mixture into stems with a TFSWAUNet.

    The input is forced mono.  ``mask_mode`` "trainer" (default) applies
    sigmoid(|re, im|) masks to the mono magnitude with the mixture phase;
    "mag_direct" uses the head channels as magnitude masks; "direct" applies
    the raw head channels to the complex mixture.  ``device`` is where the
    model runs: "cuda" unless the caller asks for "cpu".
    """

    def __init__(self, model: TFSWAUNet, stft_processor: STFTProcessor,
                 normalizer: Optional[SpectrogramNormalizer] = None,
                 segment_length: float = 10.0, overlap: float = 0.25,
                 mask_mode: str = "trainer",
                 stem_names: Sequence[str] = ("vocals", "other"),
                 segment_batch: int = 8, transfer_dtype: str = "float32",
                 device_ola: bool = False, ola_bucket_seconds: float = 60.0,
                 freq_policy: str = "full", device="cuda"):
        if transfer_dtype not in _TRANSFER_DTYPES:
            raise NotImplementedError(
                f"transfer_dtype={transfer_dtype!r} is not ported (ported: "
                f"{_TRANSFER_DTYPES})")
        if freq_policy not in ("full", "crop_pow2"):
            raise ValueError(f"unknown freq_policy {freq_policy!r}")
        if mask_mode not in ("trainer", "mag_direct", "direct"):
            raise ValueError(f"unknown mask_mode {mask_mode!r}")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.stft_processor = stft_processor
        self.normalizer = normalizer
        self.segment_length = segment_length
        self.overlap = overlap
        self.mask_mode = mask_mode
        self.default_stems = tuple(stem_names)
        self.segment_batch = segment_batch
        self.transfer_dtype = np.dtype(transfer_dtype)
        self.device_ola = device_ola
        self.freq_policy = freq_policy
        self.sample_rate = stft_processor.sample_rate
        self.segment_samples = int(segment_length * self.sample_rate)
        self.hop_samples = int(self.segment_samples * (1 - overlap))
        self.ola_bucket_samples = int(ola_bucket_seconds * self.sample_rate)
        # segments per device-OLA window, so a window spans about
        # ola_bucket_seconds of audio
        self.ola_window_segments = max(
            1, round((self.ola_bucket_samples - self.segment_samples)
                     / max(self.hop_samples, 1)) + 1)
        self.n_stems = model.out_channels // 2
        # in_channels 2: mono [re, im]; 4: mono duplicated to stereo
        self.model_audio_channels = model.in_channels // 2

    # ----------------------------------------------------- transfer codecs
    def _encode_host(self, x: np.ndarray) -> np.ndarray:
        if self.transfer_dtype == np.int16:
            return np.clip(np.rint(x * _INT16_SCALE), -32768, 32767).astype(np.int16)
        return x.astype(self.transfer_dtype)

    def _decode_host(self, x: np.ndarray) -> np.ndarray:
        if self.transfer_dtype == np.int16:
            return x.astype(np.float32) / _INT16_SCALE
        return x.astype(np.float32)

    def _encode_dev(self, x: torch.Tensor) -> torch.Tensor:
        if self.transfer_dtype == np.int16:
            return torch.clamp(torch.round(x * _INT16_SCALE), -32768, 32767).to(torch.int16)
        return x.to(getattr(torch, self.transfer_dtype.name))

    def _decode_dev(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.int16:
            return x.float() / _INT16_SCALE
        return x.float()

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # --------------------------------------------------------------- core
    def _separate_batch(self, segments: torch.Tensor) -> torch.Tensor:
        """(B, S) encoded mono segments -> (B, n_stems, S) encoded."""
        return self._encode_dev(self._separate_core(self._decode_dev(segments)))

    def _separate_core(self, segments: torch.Tensor) -> torch.Tensor:
        """(B, S) mono segments -> (B, n_stems, S) separated audio (f32)."""
        S = segments.shape[1]
        wav = segments.float()[:, None, :].expand(-1, self.model_audio_channels, -1)
        spec = self.stft_processor.stft(wav)                 # (B, C, F, T)
        model_input = self.stft_processor.to_model_input(spec)
        F_full = model_input.shape[2]
        if self.freq_policy == "crop_pow2" and F_full % 2 == 1:
            model_input = model_input[:, :, :-1, :]          # drop the Nyquist row
        stats = None
        if self.normalizer is not None:
            model_input, mean, std = self.normalizer(model_input, return_stats=True)
            stats = (mean, std)
        out = self.model(model_input)
        if stats is not None:
            out = self.normalizer.denormalize(out, *stats)
        if out.shape[2] != F_full:
            # replicate the last computed mask row onto the Nyquist bin
            out = torch.cat([out, out[:, :, -1:, :]], dim=2)

        if self.mask_mode == "trainer":
            mono = spec.mean(dim=1)
            masked = trainer_masked_complex(out, mono.abs(), mono.angle(), self.n_stems)
            return self.stft_processor.istft(masked, length=S)
        if self.mask_mode == "mag_direct":
            mono = spec.mean(dim=1)
            mags = apply_magnitude_masks(out, mono.abs(), self.n_stems, "direct")
            masked = torch.polar(mags, mono.angle()[:, None].expand_as(mags))
            return self.stft_processor.istft(masked, length=S)
        masked = apply_direct_masks(out, spec, self.n_stems)   # (B, S, C, F, T)
        return self.stft_processor.istft(masked, length=S).mean(dim=2)

    def _device_ola_window(self, window: torch.Tensor, n_valid: int) -> torch.Tensor:
        """One OLA window: the window's K segments, masked to the first
        ``n_valid``; returns the un-normalised Hann-weighted accumulation
        (n_stems, W), encoded."""
        seg, hop = self.segment_samples, self.hop_samples
        K = self.ola_window_segments
        W = (K - 1) * hop + seg
        dev = window.device
        idx = (torch.arange(K, device=dev)[:, None] * hop
               + torch.arange(seg, device=dev)[None, :])
        segments = self._decode_dev(window)[idx]             # (K, seg)
        # least padding, then the largest batch <= segment_batch
        bs = min(range(1, self.segment_batch + 1),
                 key=lambda b: ((-(-K // b)) * b - K, -b))
        nb = -(-K // bs)
        if nb * bs > K:
            segments = torch.nn.functional.pad(segments, (0, 0, 0, nb * bs - K))
        outs = torch.cat([self._separate_core(segments[i * bs:(i + 1) * bs])
                          for i in range(nb)])[:K]           # (K, n_stems, seg)
        valid = (torch.arange(K, device=dev) < n_valid).float()
        hann = torch.from_numpy(_hann(seg)).to(dev)
        weighted = outs * (hann[None, None, :] * valid[:, None, None])
        acc = torch.zeros((self.n_stems, W), dtype=torch.float32, device=dev)
        acc.index_add_(1, idx.reshape(-1),
                       weighted.permute(1, 0, 2).reshape(self.n_stems, -1))
        return self._encode_dev(acc)

    def _dispatch_long_device(self, audio: np.ndarray) -> Dict:
        """Enqueue every OLA window of one track; returns what
        :meth:`_collect_long_device` needs."""
        total = audio.shape[1]
        seg, hop = self.segment_samples, self.hop_samples
        K = self.ola_window_segments
        W = (K - 1) * hop + seg
        n_seg = -(-max(total - seg, 0) // hop) + 1
        n_win = -(-n_seg // K)
        S_needed = (n_win * K - 1) * hop + seg
        track = self._encode_host(np.pad(audio[0], (0, S_needed - total)))
        handles = []
        for w in range(n_win):
            o = w * K * hop
            handles.append(self._device_ola_window(self._put(track[o:o + W]),
                                                   min(K, n_seg - w * K)))
        return {"handles": handles, "total": total, "n_seg": n_seg,
                "S_needed": S_needed}

    def _collect_long_device(self, meta: Dict, stems: List[str]) -> Dict[str, np.ndarray]:
        """Fetch, decode and normalise one dispatched track."""
        total, n_seg, S_needed = meta["total"], meta["n_seg"], meta["S_needed"]
        seg, hop = self.segment_samples, self.hop_samples
        K = self.ola_window_segments
        W = (K - 1) * hop + seg
        acc = np.zeros((self.n_stems, S_needed), np.float32)
        for w, h in enumerate(meta["handles"]):
            o = w * K * hop
            acc[:, o:o + W] += self._decode_host(h.cpu().numpy())
        hann = _hann(seg)
        norm = np.zeros(S_needed, dtype=np.float32)
        for i in range(n_seg):
            norm[i * hop:i * hop + seg] += hann
        out = acc[:, :total] / np.maximum(norm[:total], 1e-8)[None]
        return {name: out[i:i + 1] for i, name in enumerate(stems)}

    # ---------------------------------------------------------------- api
    @torch.inference_mode()
    def separate(self, audio, stem_names: Optional[Sequence[str]] = None
                 ) -> Dict[str, np.ndarray]:
        """Separate a mixture [channels, time] or [time] -> {stem: (1, time)}."""
        stems = list(stem_names or self.default_stems)[: self.n_stems]
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 1:
            audio = audio[None]
        if audio.shape[0] > 1:
            audio = audio.mean(axis=0, keepdims=True)        # force mono
        total = audio.shape[1]
        seg = self.segment_samples
        if total <= seg:
            block = self._encode_host(np.pad(audio[0], (0, seg - total)))[None]
            out = self._decode_host(
                self._separate_batch(self._put(block)).cpu().numpy())[0, :, :total]
            return {name: out[i:i + 1] for i, name in enumerate(stems)}
        if self.device_ola:
            return self._collect_long_device(self._dispatch_long_device(audio), stems)
        return self._separate_long(audio, stems)

    def _separate_long(self, audio: np.ndarray, stems: List[str]) -> Dict[str, np.ndarray]:
        """Hann overlap-add over fixed segments with the reference's
        last-segment clamping, segments in batches of ``segment_batch``."""
        total = audio.shape[1]
        seg, hop = self.segment_samples, self.hop_samples
        num_segments = (total - seg) // hop + 1
        window = _hann(seg)
        bounds = []
        for i in range(num_segments):
            start, end = i * hop, i * hop + seg
            if end > total:
                end = total
                start = max(0, end - seg)
            bounds.append((start, end))
        batch = np.zeros((len(bounds), seg), dtype=np.float32)
        for j, (start, end) in enumerate(bounds):
            batch[j, : end - start] = audio[0, start:end]
        batch = self._encode_host(batch)

        bs, n = self.segment_batch, len(bounds)
        handles = []
        for j0 in range(0, n, bs):
            block = batch[j0:j0 + bs]
            if block.shape[0] < bs:
                block = np.pad(block, ((0, bs - block.shape[0]), (0, 0)))
            handles.append(self._separate_batch(self._put(block)))
        separated = np.concatenate([
            self._decode_host(h.cpu().numpy())[: min(bs, n - j0)]
            for j0, h in zip(range(0, n, bs), handles)])     # (n, n_stems, seg)

        out = {name: np.zeros((1, total), dtype=np.float32) for name in stems}
        norm = np.zeros(total, dtype=np.float32)
        for j, (start, end) in enumerate(bounds):
            length = end - start
            w = window[:length]
            for i, name in enumerate(stems):
                out[name][0, start:end] += separated[j, i, :length] * w
            norm[start:end] += w
        norm = np.maximum(norm, 1e-8)
        for name in stems:
            out[name] /= norm[None]
        return out


def load_separator_from_checkpoint(
    checkpoint_path: str,
    model_config: Optional[ModelConfig] = None,
    stft_config: Optional[STFTConfig] = None,
    eval_config: Optional[EvalConfig] = None,
    stem_names: Sequence[str] = ("vocals", "other"),
    device="cuda",
) -> SourceSeparator:
    """A SourceSeparator from a PyTorch ``.pt`` / ``.pth`` checkpoint in the
    reference's state_dict naming, such as the trainer's
    ``<checkpoint_dir>/best/checkpoint.pt`` (pass the ModelConfig of its
    ``config.json`` for its compute dtype and route).  Every ported EvalConfig knob is honoured
    (``EvalConfig.fast_serving()`` for the serving preset); the STFT runs in
    float32 whatever ``stft_precision`` says.  Orbax checkpoints are a JAX
    format and are not read here."""
    if not (os.path.isfile(checkpoint_path)
            and checkpoint_path.endswith((".pt", ".pth"))):
        raise NotImplementedError(
            "only .pt/.pth checkpoints load into the PyTorch port")
    stft_config = stft_config or STFTConfig()
    eval_config = eval_config or EvalConfig()
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("model_state_dict", ckpt)
    cfg = ckpt.get("config", {}) if isinstance(ckpt, dict) else {}
    if model_config is None:
        model_config = ModelConfig(
            in_channels=cfg.get("in_channels", 2),
            out_channels=cfg.get("out_channels", 2),
            depths=tuple(cfg.get("depths", (2, 2, 6, 2))),
            dims=tuple(cfg.get("dims", (32, 64, 128, 256))),
            window_size=cfg.get("window_size", 8),
            shift_size=cfg.get("shift_size", 4),
            num_heads=cfg.get("num_heads", 8),
        )
    model = TFSWAUNet.from_config(model_config)
    # the reference registers an unused SWA mask buffer
    model.load_state_dict({k: v for k, v in state_dict.items() if "attn_mask" not in k})
    return SourceSeparator(
        model=model,
        stft_processor=STFTProcessor(stft_config),
        normalizer=SpectrogramNormalizer("instance") if eval_config.normalize else None,
        segment_length=eval_config.segment_seconds,
        overlap=eval_config.overlap,
        mask_mode=eval_config.mask_mode,
        stem_names=stem_names,
        segment_batch=eval_config.segment_batch,
        transfer_dtype=eval_config.transfer_dtype,
        device_ola=eval_config.device_ola,
        ola_bucket_seconds=eval_config.ola_bucket_seconds,
        freq_policy=eval_config.freq_policy,
        device=device,
    )
