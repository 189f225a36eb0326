"""``utils/profiling.py`` (trace, annotate, detect_chip, flops_of, MFU) and
``TFSWAUNet.get_model_info`` against the JAX package's, on the CPU."""
import glob
import json
import os

import numpy as np
import pytest
import torch

from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.utils import profiling

from _torch_small_model import SMALL


def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    a = torch.randn(32, 16)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("port/matmul"):
            a @ a.T
    names = {e.name for e in prof.events()}
    assert "port/matmul" in names and "aten::mm" in names
    files = glob.glob(os.path.join(str(tmp_path), "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "port/matmul" for e in events)


def test_detect_chip_and_its_peak():
    chip = profiling.detect_chip()
    if torch.cuda.is_available():
        assert chip == ("h100" if "H100" in torch.cuda.get_device_name(0) else "gpu")
    else:
        assert chip == "cpu"
    assert profiling.PEAK_FLOPS["h100"] == 989e12


@pytest.mark.parametrize("M,N,K", [(8, 16, 32), (33, 7, 64)])
def test_flops_of_a_matmul(M, N, K):
    a, b = torch.randn(M, K), torch.randn(K, N)
    assert profiling.flops_of(torch.matmul, a, b) == 2 * M * N * K
    assert profiling.flops_of(lambda: a + 1) is None


def test_step_timer_mfu():
    timer = profiling.StepTimer(flops_per_step=2e9, items_per_step=4)
    timer._times = [0.5, 0.5]
    m = timer.metrics()
    peak = profiling.PEAK_FLOPS[profiling.detect_chip()] * max(1, torch.cuda.device_count())
    assert m["mfu"] == pytest.approx(2e9 / 0.5 / peak)
    assert m["items_per_sec"] == pytest.approx(8.0)
    assert "mfu" not in profiling.StepTimer(items_per_step=4).metrics()


def test_get_model_info_matches_jax():
    pm = TFSWAUNet(4, 4, **SMALL)
    jm = JaxUNet(in_channels=4, out_channels=4, **SMALL)
    from tfswa_tpu_torch.weights import variables_from_state_dict

    params = variables_from_state_dict(pm.state_dict(), SMALL["depths"])["params"]
    want, got = jm.get_model_info(params), pm.get_model_info(pm.parameters())
    assert got.pop("architecture") == "TFSWA-UNet (tfswa_tpu_torch)"
    want.pop("architecture")
    assert got == want and got["num_parameters"] == pm.count_parameters()
    assert pm.get_model_info(dict(pm.named_parameters()))["num_parameters"] == \
        got["num_parameters"]
    no_params = pm.get_model_info()
    assert "num_parameters" not in no_params
    assert no_params == {k: v for k, v in jm.get_model_info().items()
                         if k != "architecture"} | {"architecture": no_params["architecture"]}
    assert np.isfinite(got["num_parameters"])
