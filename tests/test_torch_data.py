"""The port's data pipeline against the JAX package's (both numpy, no
device arithmetic, so every comparison is exact):
  - the numpy WAV reader on files in PCM16, PCM24, PCM32 and IEEE float32,
    plain and WAVE_FORMAT_EXTENSIBLE, with an odd-sized chunk before the
    data: against the samples written (decoded here independently) and,
    when it builds, the JAX package's C++ reader, at odd offsets and past
    the end;
  - ``MUSDB18Dataset`` on a small written tree: splits, index, items and
    full tracks equal the JAX dataset's (which reads through the C++
    reader, or through the port's reader where g++ is missing);
  - the musdb-package branch through a fake ``musdb`` module;
  - ``DataLoader``: the same batches in the same order for the same seed,
    with and without worker threads; ``prefetch_to_device``.
"""
import struct
import sys
import types

import numpy as np
import pytest
import torch

from tfswa_tpu import native
from tfswa_tpu.data import musdb as jmusdb
from tfswa_tpu.data import pipeline as jpipeline
from tfswa_tpu_torch.data import musdb as pmusdb
from tfswa_tpu_torch.data import pipeline as ppipeline
from tfswa_tpu_torch.data.synthetic import SyntheticDataset
from tfswa_tpu_torch.data.wav import wav_info, wav_read, write_wav

SR = 8000
# name -> (format tag, bits, extensible)
ENCODINGS = {"pcm16": (1, 16, False), "pcm24": (1, 24, False), "pcm32": (1, 32, False),
             "float32": (3, 32, False), "pcm24_ext": (1, 24, True),
             "float32_ext": (3, 32, True)}


def _native():
    """The JAX package's C++ reader, or None where g++ cannot build it."""
    return native if native.available() else None


def _write(path, data, name):
    """Planar float32 (channels, frames) in the encoding ``name``; returns
    the samples the file holds, decoded here (float32, planar)."""
    tag, bits, ext = ENCODINGS[name]
    ch, n = data.shape
    inter = np.ascontiguousarray(data.T)
    if tag == 3:
        raw, decoded = inter.astype("<f4").tobytes(), inter.astype(np.float32)
    else:
        scale = 2 ** (bits - 1)
        ints = np.clip(np.round(inter.astype(np.float64) * scale), -scale, scale - 1).astype(np.int64)
        decoded = (ints.astype(np.float32) / np.float32(scale))
        if bits == 24:
            u = (ints & 0xFFFFFF).astype("<u4")
            raw = np.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF], -1).astype(np.uint8).tobytes()
        else:
            raw = ints.astype(f"<i{bits // 8}").tobytes()
    block = ch * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if ext else tag, ch, SR, SR * block, block, bits)
    if ext:
        guid_tail = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
        fmt += struct.pack("<HHIH", 22, bits, 3, tag) + guid_tail
    junk = b"odd"   # a 3-byte chunk, padded to 4 in the file
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"LIST" + struct.pack("<I", len(junk)) + junk + b"\x00"
            + b"data" + struct.pack("<I", len(raw)) + raw)
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return decoded.T


@pytest.mark.parametrize("name", sorted(ENCODINGS))
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_read_every_encoding(tmp_path, name, channels):
    rng = np.random.default_rng(channels)
    data = (rng.standard_normal((channels, 1001)) * 0.3).astype(np.float32)
    path = str(tmp_path / f"{name}.wav")
    samples = _write(path, data, name)
    assert wav_info(path) == (1001, channels, SR)
    nat = _native()
    for start, n in [(0, 1001), (37, 500), (999, 7), (1001, 5), (5000, 3), (-3, 10)]:
        got = wav_read(path, start, n, 2)
        want = np.zeros((2, n), np.float32)
        first = max(start, 0)
        m = max(0, min(n, 1001 - first))
        want[:, :m] = samples[np.minimum(np.arange(2), channels - 1), first:first + m]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pmusdb.load_chunk(path, start, n), got)
        if nat is not None:
            np.testing.assert_array_equal(got, nat.wav_read(path, start, n, 2))
    assert pmusdb.audio_file_frames(path) == 1001
    if nat is not None:
        assert nat.wav_info(path)[0] == 1001


def test_truncated_data_chunk_reads_what_the_file_holds(tmp_path):
    path = str(tmp_path / "t.wav")
    samples = _write(path, np.full((2, 100), 0.25, np.float32), "pcm16")
    with open(path, "r+b") as fh:
        fh.truncate(fh.seek(0, 2) - 40)             # 10 stereo frames short
    got = wav_read(path, 80, 20, 2)
    np.testing.assert_array_equal(got[:, :10], samples[:, 80:90])
    assert not got[:, 10:].any()
    nat = _native()
    if nat is not None:
        np.testing.assert_array_equal(got, nat.wav_read(path, 80, 20, 2))


def test_unsupported_encoding_raises(tmp_path):
    path = str(tmp_path / "u8.wav")
    _write(path, np.zeros((1, 10), np.float32), "pcm16")
    with open(path, "r+b") as fh:          # 16-bit PCM -> 16-bit "A-law" (tag 6)
        fh.seek(20)
        fh.write(struct.pack("<H", 6))
    assert wav_info(path) == (10, 1, SR)
    with pytest.raises(IOError, match="unsupported"):
        wav_read(path, 0, 10, 2)


def test_write_wav_is_the_native_writer(tmp_path):
    rng = np.random.default_rng(0)
    data = (rng.standard_normal((2, 777)) * 0.6).astype(np.float32)    # some clip
    write_wav(str(tmp_path / "p.wav"), data, SR)
    pcm = (np.clip(data, -1, 1) * np.float32(32767)).astype(np.int16)  # truncated
    np.testing.assert_array_equal(wav_read(str(tmp_path / "p.wav"), 0, 777, 2),
                                  pcm.astype(np.float32) / np.float32(32768))
    nat = _native()
    if nat is not None:
        nat.wav_write(str(tmp_path / "n.wav"), data, SR)
        assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "n.wav").read_bytes()


TRACKS = ["Actions - One Minute Smile", "Alpha Track", "Beta Track", "Young Griffo - Pennies",
          "Gamma Track"]


@pytest.fixture(scope="module")
def musdb_tree(tmp_path_factory):
    """root/{train,test}/<track>/{vocals,drums,bass,other}.wav, PCM16, odd
    lengths, two validation tracks among the train ones."""
    root = tmp_path_factory.mktemp("musdb")
    rng = np.random.default_rng(0)
    for subset, names in (("train", TRACKS), ("test", ["Test One", "Test Two"])):
        for i, name in enumerate(names):
            d = root / subset / name
            d.mkdir(parents=True)
            n = int(SR * 1.3) + 17 * i
            for stem in ("vocals", "drums", "bass", "other"):
                write_wav(str(d / f"{stem}.wav"),
                          (rng.standard_normal((2, n)) * 0.2).astype(np.float32), SR)
    return str(root)


@pytest.fixture
def jax_reads(monkeypatch):
    """The JAX dataset reads through its C++ reader; where g++ is missing,
    through the port's (the splits, index and stem logic stay the JAX's)."""
    if _native() is None:
        shim = types.SimpleNamespace(wav_read=wav_read, wav_info=wav_info)
        monkeypatch.setattr(jmusdb, "_native_io", lambda: shim)


DATASETS = [
    dict(split="train"), dict(split="valid"), dict(split="test"),
    dict(split="train", random_segments=False, segment_overlap=0.25, max_segments_per_track=3),
    dict(split="valid", random_segments=False),
    dict(split="test", stems=("vocals", "drums", "bass", "other"), seed=3),
]


@pytest.mark.parametrize("kw", DATASETS, ids=[str(i) for i in range(len(DATASETS))])
def test_musdb_dataset_matches_jax(musdb_tree, jax_reads, kw):
    kw = dict(dict(segment_seconds=0.3, sample_rate=SR), **kw)
    a, b = pmusdb.MUSDB18Dataset(musdb_tree, **kw), jmusdb.MUSDB18Dataset(musdb_tree, **kw)
    assert a.track_names == b.track_names and len(a) == len(b) > 0
    assert a._track_lengths == b._track_lengths
    if not kw.get("random_segments", True):
        assert a._index == b._index
    for epoch in (0, 2):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        for i in range(len(a)):
            (ma, ta), (mb, tb) = a[i], b[i]
            np.testing.assert_array_equal(ma, mb)
            assert list(ta) == list(tb)
            for k in tb:
                np.testing.assert_array_equal(ta[k], tb[k])
    (ma, ta), (mb, tb) = a.get_full_track(len(a.tracks) - 1), b.get_full_track(len(b.tracks) - 1)
    np.testing.assert_array_equal(ma, mb)
    for k in tb:
        np.testing.assert_array_equal(ta[k], tb[k])


def test_musdb_splits_and_binary_other(musdb_tree):
    train = pmusdb.MUSDB18Dataset(musdb_tree, "train", segment_seconds=0.3, sample_rate=SR,
                                  random_segments=False)
    valid = pmusdb.MUSDB18Dataset(musdb_tree, "valid", segment_seconds=0.3, sample_rate=SR)
    assert valid.track_names == [t for t in TRACKS if t in pmusdb.VALIDATION_TRACKS] \
        == ["Actions - One Minute Smile", "Young Griffo - Pennies"]
    assert not set(train.track_names) & set(valid.track_names)
    mixture, targets = train[1]
    ti, start = train._index[1]
    src = {s: pmusdb.load_chunk(f"{train.tracks[ti]}/{s}.wav", start, train.segment_samples)
           for s in pmusdb.ALL_SOURCES}
    np.testing.assert_array_equal(targets["other"], src["drums"] + src["bass"] + src["other"])
    np.testing.assert_allclose(mixture, targets["vocals"] + targets["other"], atol=1e-6)
    batch = pmusdb.collate([train[0], train[1]])
    assert batch[0].shape == (2, 2, train.segment_samples) and set(batch[1]) == {"vocals", "other"}


class _FakeTrack:
    def __init__(self, name, seed):
        self.name, self.rate, self.duration = name, SR, 2.0
        self.chunk_start, self.chunk_duration = 0.0, None
        rng = np.random.default_rng(seed)
        self._sources = {s: (rng.standard_normal((2 * SR, 2)) * 0.1).astype(np.float32)
                         for s in pmusdb.ALL_SOURCES}

    def _window(self, audio):
        start = int(self.chunk_start * self.rate)
        if self.chunk_duration is None:
            return audio[start:]
        return audio[start:start + int(self.chunk_duration * self.rate)]

    @property
    def audio(self):
        return self._window(sum(self._sources.values()))

    @property
    def targets(self):
        return {s: types.SimpleNamespace(audio=self._window(a)) for s, a in self._sources.items()}


def test_musdb_package_branch_through_a_fake_module(monkeypatch, tmp_path, jax_reads):
    calls = []

    class FakeDB:
        def __init__(self, root=None, subsets=None, split=None):
            calls.append((subsets, split))
            self.tracks = [_FakeTrack("Fake A", 0), _FakeTrack("Fake B", 1)]

    monkeypatch.setitem(sys.modules, "musdb", types.SimpleNamespace(DB=FakeDB))
    for kw in (dict(split="train"), dict(split="valid", random_segments=False,
                                         max_segments_per_track=2), dict(split="test")):
        kw = dict(dict(segment_seconds=0.5, sample_rate=SR), **kw)
        a = pmusdb.MUSDB18Dataset(str(tmp_path), **kw)
        b = jmusdb.MUSDB18Dataset(str(tmp_path), **kw)
        assert a._mode == "pkg" and a.track_names == b.track_names == ["Fake A", "Fake B"]
        assert len(a) == len(b)
        for i in range(len(a)):
            (ma, ta), (mb, tb) = a[i], b[i]
            np.testing.assert_array_equal(ma, mb)
            for k in tb:
                np.testing.assert_array_equal(ta[k], tb[k])
        np.testing.assert_array_equal(a.get_full_track(1)[0], b.get_full_track(1)[0])
    assert calls[::2] == [(["train"], "train"), (["train"], "valid"), (["test"], None)]


def test_no_tracks_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "musdb", None)     # the package is absent
    with pytest.raises(FileNotFoundError):
        pmusdb.MUSDB18Dataset(str(tmp_path))


@pytest.mark.parametrize("workers", [0, 3])
def test_dataloader_batches_match_jax(workers):
    kw = dict(num_tracks=7, track_seconds=0.5, segment_seconds=0.1, sample_rate=SR, seed=2)
    pa = ppipeline.DataLoader(SyntheticDataset(**kw), batch_size=2, num_workers=workers, seed=5)
    from tfswa_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
    pb = jpipeline.DataLoader(JaxSynthetic(**kw), batch_size=2, num_workers=0, seed=5)
    assert len(pa) == len(pb) == 3
    for _ in range(2):                                  # two epochs: fresh shuffles
        got, want = list(pa), list(pb)
        assert len(got) == len(want) == 3
        for (ma, ta), (mb, tb) in zip(got, want):
            np.testing.assert_array_equal(ma, mb)
            for k in tb:
                np.testing.assert_array_equal(ta[k], tb[k])


def test_dataloader_keeps_the_last_batch_and_shards():
    ds = SyntheticDataset(num_tracks=5, track_seconds=0.5, segment_seconds=0.1,
                          sample_rate=SR, random_segments=False)
    loader = ppipeline.DataLoader(ds, 4, shuffle=False, num_workers=2, drop_last=False)
    assert [b[0].shape[0] for b in loader] == [4, 4, 4, 4, 4, 4, 1] and len(loader) == 7
    half = ppipeline.DataLoader(ds, 4, shuffle=False, num_workers=0, num_shards=2,
                                shard_index=1)
    full = list(ppipeline.DataLoader(ds, 4, shuffle=False, num_workers=0))
    np.testing.assert_array_equal(next(iter(half))[0], full[0][0][2:])
    with pytest.raises(ValueError):
        ppipeline.DataLoader(ds, 3, num_shards=2)


def test_dataloader_raises_a_worker_error():
    class Broken(SyntheticDataset):
        def __getitem__(self, idx):
            if idx == 3:
                raise RuntimeError("bad item")
            return super().__getitem__(idx)

    ds = Broken(num_tracks=6, track_seconds=0.5, segment_seconds=0.1, sample_rate=SR)
    with pytest.raises(RuntimeError, match="bad item"):
        list(ppipeline.DataLoader(ds, 2, shuffle=False, num_workers=2))


def test_prefetch_to_device_keeps_order_and_values():
    batches = [(np.full((2, 2, 8), i, np.float32), {"vocals": np.full((2, 2, 8), -i, np.float32)})
               for i in range(5)]
    out = list(ppipeline.prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    for i, (m, t) in enumerate(out):
        assert isinstance(m, torch.Tensor) and m.device.type == "cpu"
        assert float(m[0, 0, 0]) == i and float(t["vocals"][0, 0, 0]) == -i


def test_dataloader_under_thread_stress_delivers_every_batch_once_in_order():
    """16 worker threads (more than the cores), a switch interval of 1 us:
    the batches equal the single-threaded loader's, each once, in order."""
    import sys
    import threading

    ds = SyntheticDataset(num_tracks=48, track_seconds=0.2, segment_seconds=0.05,
                          sample_rate=SR, seed=4)
    want = list(ppipeline.DataLoader(ds, 4, num_workers=0, seed=1))
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        worker = threading.Thread(
            target=lambda: got.extend(ppipeline.DataLoader(ds, 4, num_workers=16, seed=1)))
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == len(want) == 12
    for (ma, _), (mb, _) in zip(got, want):
        np.testing.assert_array_equal(ma, mb)


def test_dataloader_stops_its_threads_when_the_consumer_stops_early():
    import threading

    ds = SyntheticDataset(num_tracks=40, track_seconds=0.2, segment_seconds=0.05,
                          sample_rate=SR)
    before = threading.active_count()
    it = iter(ppipeline.DataLoader(ds, 2, num_workers=3))
    next(it)
    it.close()                      # joins the producer, which drains its pool
    assert threading.active_count() == before
