"""A ``soundfile`` stand-in for the tests that run the JAX package's WAV
paths (``separate_file``, ``cli.separate._stream_files``,
``CustomDatasetEvaluator.evaluate``), which import ``soundfile``: the
package is not installed.  It reads and writes through the port's numpy
WAV code, so both packages see the same samples.  A test installs it with
``monkeypatch.setitem(sys.modules, "soundfile", standin())``."""
import types

import numpy as np

from tfswa_tpu_torch.data.wav import wav_info, wav_read, write_wav


def standin() -> types.ModuleType:
    def read(path, dtype="float32", always_2d=False):
        frames, channels, sr = wav_info(path)
        data = wav_read(path, 0, frames, channels).T.astype(dtype)   # (frames, channels)
        return (data if always_2d or channels > 1 else data[:, 0]), sr

    def write(path, data, samplerate):
        data = np.asarray(data, np.float32)
        write_wav(path, data[None] if data.ndim == 1 else data.T, samplerate)

    mod = types.ModuleType("soundfile")
    mod.read, mod.write = read, write
    return mod
