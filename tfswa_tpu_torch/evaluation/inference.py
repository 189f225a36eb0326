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
Audio crosses the host-device boundary in ``transfer_dtype``; "int8" sends
the device-OLA windows back as int8 with one scale a stem (input audio,
the host-OLA path and the single-segment path ride float16).

On the card every copy is asynchronous: uploads are staged in pinned host
memory and copied with ``non_blocking=True`` (a copy from pageable memory
would first wait for all the work queued on the stream), and each result
comes back into a pinned host buffer through a ``non_blocking`` copy and a
CUDA event that the collecting side waits on.  PyTorch's pinned-memory
allocator records each copy's event and reuses no buffer until it has
passed.  So the host can queue the next window, or the next track
(``separate_stream``), while the card works.

Under a mesh (``mesh=``, every rank calling with the same track) each
batch of segments is split over the data axis: each data rank separates
``bs / d`` of them (through the tensor-parallel model when the model axis
has more than one rank) and the stems are gathered to every rank, so that
the overlap-add, and the result, are the same on each.  The batch is
rounded up to a multiple of d, the device OLA picks its batch from the
multiples of d, and a track of one segment or less is padded to d rows.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import EvalConfig, ModelConfig, STFTConfig
from ..data.wav import wav_info, wav_read, write_wav
from ..models.tfswa_unet import TFSWAUNet
from ..ops.masking import (apply_direct_masks, apply_magnitude_masks,
                           trainer_masked_complex)
from ..ops.stft import STFTProcessor, SpectrogramNormalizer, get_window
from ..parallel.comm import gather_rows
from ..parallel.sharding import load_whole_state_dict, shard_model

# int16 transfer scaling: 4x headroom over full-scale audio.
_INT16_SCALE = 8192.0
_TRANSFER_DTYPES = ("float32", "float16", "int16", "int8")


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
                 freq_policy: str = "full", device="cuda", mesh=None):
        if transfer_dtype not in _TRANSFER_DTYPES:
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r} (known: "
                             f"{_TRANSFER_DTYPES})")
        if freq_policy not in ("full", "crop_pow2"):
            raise ValueError(f"unknown freq_policy {freq_policy!r}")
        if mask_mode not in ("trainer", "mag_direct", "direct"):
            raise ValueError(f"unknown mask_mode {mask_mode!r}")
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
            if getattr(model, "mesh", None) is not mesh:
                model = shard_model(model, mesh)
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.stft_processor = stft_processor
        self.normalizer = normalizer
        self.segment_length = segment_length
        self.overlap = overlap
        self.mask_mode = mask_mode
        self.default_stems = tuple(stem_names)
        self.data_ranks = 1 if mesh is None else mesh.data.size
        # every data rank gets equal work
        self.segment_batch = -(-segment_batch // self.data_ranks) * self.data_ranks
        # "int8": the device-OLA windows come back as int8 with a scale a
        # stem; everything else rides float16
        self.int8_output = transfer_dtype == "int8"
        self.transfer_dtype = np.dtype("float16" if self.int8_output else transfer_dtype)
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

    def update_variables(self, state_dict) -> None:
        """Load new weights (a whole state_dict) into the model, cut to the
        rank's shards under a mesh."""
        load_whole_state_dict(self.model, state_dict)

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
        """Host array -> tensor on the model's device; on the card through a
        pinned staging buffer and a ``non_blocking`` copy."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return t.to(self.device)
        staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        staged.copy_(t)
        return staged.to(self.device, non_blocking=True)

    @staticmethod
    def _fetch(t: torch.Tensor) -> Tuple[torch.Tensor, Optional["torch.cuda.Event"]]:
        """Start the copy of ``t`` to the host: on the card a ``non_blocking``
        copy into a pinned buffer and the event that marks its end; on the
        CPU ``t`` itself.  :meth:`_host` waits for it."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _host(fetched) -> np.ndarray:
        host, done = fetched
        if done is not None:
            done.synchronize()
        return host.numpy()

    # --------------------------------------------------------------- core
    def _separate_batch(self, segments: torch.Tensor) -> torch.Tensor:
        """(B, S) encoded mono segments -> (B, n_stems, S) encoded."""
        return self._encode_dev(self._separate_rows(self._decode_dev(segments)))

    def _separate_rows(self, segments: torch.Tensor) -> torch.Tensor:
        """:meth:`_separate_core` of (B, S) segments; under a mesh this
        data rank's B / d of them, the stems gathered over the data axis."""
        if self.mesh is None:
            return self._separate_core(segments)
        axis = self.mesh.data
        b = segments.shape[0] // axis.size
        return gather_rows(self._separate_core(segments[axis.index * b:(axis.index + 1) * b]),
                           axis)

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

    def _device_ola_window(self, window: torch.Tensor, n_valid: int):
        """One OLA window: the window's K segments, masked to the first
        ``n_valid``; returns the un-normalised Hann-weighted accumulation
        (n_stems, W), encoded, or under "int8" its int8 codes and the
        stems' scales padded to 8."""
        seg, hop = self.segment_samples, self.hop_samples
        K = self.ola_window_segments
        W = (K - 1) * hop + seg
        dev = window.device
        idx = (torch.arange(K, device=dev)[:, None] * hop
               + torch.arange(seg, device=dev)[None, :])
        segments = self._decode_dev(window)[idx]             # (K, seg)
        # least padding, then the largest batch <= segment_batch, from the
        # multiples of the data ranks
        d = self.data_ranks
        bs = min(range(d, self.segment_batch + 1, d),
                 key=lambda b: ((-(-K // b)) * b - K, -b))
        nb = -(-K // bs)
        if nb * bs > K:
            segments = torch.nn.functional.pad(segments, (0, 0, 0, nb * bs - K))
        outs = torch.cat([self._separate_rows(segments[i * bs:(i + 1) * bs])
                          for i in range(nb)])[:K]           # (K, n_stems, seg)
        valid = (torch.arange(K, device=dev) < n_valid).float()
        hann = self._put(_hann(seg))
        weighted = outs * (hann[None, None, :] * valid[:, None, None])
        acc = torch.zeros((self.n_stems, W), dtype=torch.float32, device=dev)
        acc.index_add_(1, idx.reshape(-1),
                       weighted.permute(1, 0, 2).reshape(self.n_stems, -1))
        if not self.int8_output:
            return self._encode_dev(acc)
        # Quantise y = acc / env, not acc: the error of env * round(y) shrinks
        # with the envelope, where the final division by it would magnify a
        # constant one at the track's edges (the envelope goes to 0).  Where
        # covered, y is an envelope-weighted mean of the segments' audio, so
        # it stays at signal scale; uncovered samples have acc == 0, and the
        # floor only guards 0 / 0.  The host rebuilds env from hann and
        # n_valid.
        env = torch.zeros(W, dtype=torch.float32, device=dev)
        env.index_add_(0, idx.reshape(-1), (hann[None, :] * valid[:, None]).reshape(-1))
        y = acc / env.clamp_min(1e-12)[None]
        smax = y.abs().amax(dim=1).clamp_min(1e-12)
        q = torch.clamp(torch.round(y * (127.0 / smax)[:, None]), -127, 127).to(torch.int8)
        return q, torch.nn.functional.pad(smax, (0, max(8, self.n_stems) - self.n_stems))

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
            out = self._device_ola_window(self._put(track[o:o + W]), min(K, n_seg - w * K))
            handles.append(tuple(self._fetch(t) for t in out) if self.int8_output
                           else self._fetch(out))
        return {"handles": handles, "total": total, "n_seg": n_seg,
                "S_needed": S_needed}

    def _collect_long_device(self, meta: Dict, stems: List[str]) -> Dict[str, np.ndarray]:
        """Fetch, decode and normalise one dispatched track."""
        total, n_seg, S_needed = meta["total"], meta["n_seg"], meta["S_needed"]
        seg, hop = self.segment_samples, self.hop_samples
        K = self.ola_window_segments
        W = (K - 1) * hop + seg
        acc = np.zeros((self.n_stems, S_needed), np.float32)
        hann = _hann(seg)
        idx = np.arange(K)[:, None] * hop + np.arange(seg)[None, :]
        for w, h in enumerate(meta["handles"]):
            o = w * K * hop
            if self.int8_output:
                # acc = env * y, env as the device built it from hann and
                # the window's valid segments
                q, smax = (self._host(f) for f in h)
                s = smax[: self.n_stems].astype(np.float32)
                nv = min(K, n_seg - w * K)
                env = np.zeros(W, np.float32)
                np.add.at(env, idx[:nv].ravel(), np.broadcast_to(hann, (nv, seg)).ravel())
                y = q.astype(np.float32) * (s / 127.0)[:, None]
                acc[:, o:o + W] += np.maximum(env, 1e-12)[None] * y
            else:
                acc[:, o:o + W] += self._decode_host(self._host(h))
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
            # one row a data rank
            block = self._encode_host(np.pad(audio[0], (0, seg - total)))[None]
            block = np.pad(block, ((0, self.data_ranks - 1), (0, 0)))
            out = self._decode_host(self._host(self._fetch(
                self._separate_batch(self._put(block)))))[0, :, :total]
            return {name: out[i:i + 1] for i, name in enumerate(stems)}
        if self.device_ola:
            return self._collect_long_device(self._dispatch_long_device(audio), stems)
        return self._separate_long(audio, stems)

    @torch.inference_mode()
    def separate_stream(self, tracks: Sequence, stem_names: Optional[Sequence[str]] = None,
                        max_in_flight: int = 2) -> List[Dict[str, np.ndarray]]:
        """Separate several tracks with up to ``max_in_flight`` of them
        dispatched to the device at once, collected in order, so that the
        card works on track k+1 while the host collects track k.  Each
        result equals :meth:`separate` on its track (the same launches and
        the same decode).  A track of one segment or less, or any track
        when ``device_ola`` is off, goes through :meth:`separate` after the
        tracks queued before it are collected."""
        stems = list(stem_names or self.default_stems)[: self.n_stems]
        queue: List[Tuple[int, Dict]] = []
        results: List[Optional[Dict[str, np.ndarray]]] = [None] * len(tracks)

        def drain_one() -> None:
            i, meta = queue.pop(0)
            results[i] = self._collect_long_device(meta, stems)

        for i, audio in enumerate(tracks):
            audio = np.asarray(audio, dtype=np.float32)
            if audio.ndim == 1:
                audio = audio[None]
            if audio.shape[0] > 1:
                audio = audio.mean(axis=0, keepdims=True)
            if not self.device_ola or audio.shape[1] <= self.segment_samples:
                while queue:
                    drain_one()
                results[i] = self.separate(audio, stems)
                continue
            # collect before dispatching, so that at most max_in_flight
            # tracks' windows are live on the device
            while len(queue) >= max_in_flight:
                drain_one()
            queue.append((i, self._dispatch_long_device(audio)))
        while queue:
            drain_one()
        return results

    def separate_file(self, input_path: str, output_dir: str,
                      stem_names: Optional[Sequence[str]] = None) -> Dict[str, str]:
        """Read a WAV, resample it to the separator's rate, separate it and
        write ``<output_dir>/<name>_<stem>.wav`` (PCM16) for each stem;
        returns {stem: path}."""
        audio, sr = read_audio(input_path)
        if sr != self.sample_rate:
            audio = _resample_poly(audio, sr, self.sample_rate)
        return write_stems(self.separate(audio, stem_names), input_path, output_dir,
                           self.sample_rate)

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
            handles.append(self._fetch(self._separate_batch(self._put(block))))
        separated = np.concatenate([
            self._decode_host(self._host(h))[: min(bs, n - j0)]
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


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """A WAV file -> (float32 (channels, frames), sample rate)."""
    frames, channels, sr = wav_info(path)
    return wav_read(path, 0, frames, channels), sr


def _resample_poly(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling along the last axis (scipy), float32 out."""
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(audio, sr_out // g, sr_in // g, axis=-1).astype(np.float32)


def write_stems(separated: Dict[str, np.ndarray], input_path: str, output_dir: str,
                sample_rate: int) -> Dict[str, str]:
    """Write each (1, S) stem of ``separated`` as
    ``<output_dir>/<input name>_<stem>.wav`` (PCM16); returns {stem: path}."""
    os.makedirs(output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(input_path))[0]
    paths = {}
    for name, wav in separated.items():
        paths[name] = os.path.join(output_dir, f"{base}_{name}.wav")
        write_wav(paths[name], wav, sample_rate)
    return paths


class BatchSeparator:
    """Sequential multi-file separation; a file that fails is recorded as
    ``{"status": "error", "error": message}`` and the next one goes on."""

    def __init__(self, separator: SourceSeparator):
        self.separator = separator

    def separate_files(self, input_paths: Sequence[str], output_dir: str) -> Dict[str, Dict]:
        results = {}
        for path in input_paths:
            try:
                results[path] = {"status": "ok",
                                 "outputs": self.separator.separate_file(path, output_dir)}
            except Exception as exc:  # noqa: BLE001 (as the JAX package: keep going)
                results[path] = {"status": "error", "error": str(exc)}
        return results


def load_separator_from_checkpoint(
    checkpoint_path: str,
    model_config: Optional[ModelConfig] = None,
    stft_config: Optional[STFTConfig] = None,
    eval_config: Optional[EvalConfig] = None,
    stem_names: Sequence[str] = ("vocals", "other"),
    device="cuda",
    mesh=None,
) -> SourceSeparator:
    """A SourceSeparator from a checkpoint: a PyTorch ``.pt`` / ``.pth``
    file in the reference's state_dict naming, or a directory the port's
    trainer wrote (its checkpoint directory, whose ``best/`` or else
    ``latest/`` is read, or one epoch directory).  The ModelConfig is
    ``model_config`` when given; else the ``.pt`` file's flat ``config``
    dict, or the ``model`` section of the directory's ``config.json``, so
    that the compute dtype and ``attention_impl`` trained with come back.
    A directory with neither raises ``ValueError``.  Every EvalConfig knob
    is honoured (``EvalConfig.fast_serving()`` for the serving preset); the
    STFT runs in float32 whatever ``stft_precision`` says.  With a ``mesh``
    the whole model is put on it (``parallel.sharding.shard_model``) and
    the separator splits its batches over the data axis."""
    from ..training.checkpointing import restore_variables

    stft_config = stft_config or STFTConfig()
    eval_config = eval_config or EvalConfig()
    if os.path.isfile(checkpoint_path) and checkpoint_path.endswith((".pt", ".pth")):
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
    else:
        state_dict, saved_cfg = restore_variables(checkpoint_path)
        if model_config is None and saved_cfg is not None:
            model_config = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                          for k, v in saved_cfg["model"].items()})
        if model_config is None:
            raise ValueError("model_config required for this checkpoint")
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
        mesh=mesh,
    )
