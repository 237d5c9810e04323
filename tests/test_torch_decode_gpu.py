"""The full-resolution JPEG decode on the card (nvJPEG), which NaFlex data takes where
the host has no libjpeg, as on the H100's host.

Every test here needs a CUDA card and the nvJPEG build, and skips without them. The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_decode_gpu.py

Tolerances: against the committed whole-image decodes (``full_decodes.npz``,
libjpeg's, equal to PIL's) the bound that the nvJPEG canvases are held to in
``chip_smoke.py``: a mean below 3 levels and a maximum below 64 (another IDCT and
chroma upsampling). A decode into memory that a queued kernel still uses must equal
the idle card's decode exactly.
"""

import os
import sys

import numpy as np
import pytest
import torch

from open_clip_tpu_torch.native import decode as nd

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets_torch")
sys.path.insert(0, ASSETS)
import make_assets  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def datas():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: nvJPEG decodes into its memory (see chip_smoke.py)")
    if nd.decoder() != "nvjpeg":
        pytest.skip("this host has libjpeg: the full decode stays on the host")
    return [open(os.path.join(ASSETS, n), "rb").read() for n in make_assets.names()]


def test_full_decode_is_close_to_the_committed_libjpeg_decode(datas):
    ref = make_assets.load_full_decodes()
    images, status = nd.decode_full_batch(datas, 4, device="cuda")
    assert status == [0] * len(datas)
    for i, image in enumerate(images):
        host = image.cpu().numpy()
        want = ref["rows"][i]
        assert image.device.type == "cuda"
        assert host[::make_assets.FULL_ROW_STEP].shape == want.shape
        d =np.abs(host[::make_assets.FULL_ROW_STEP].astype(int) - want.astype(int))
        assert d.mean() < 3.0 and d.max() < 64, (ref["names"][i], d.mean(), d.max())


def test_decode_waits_for_the_allocating_stream(datas):
    """Memory freed on the host while a kernel queued on its stream still reads and
    writes it is handed to the decode at once: nvJPEG must write after that kernel."""
    (idle,), status = nd.decode_full_batch([datas[4]], 1, device="cuda")
    torch.cuda.synchronize()
    assert status == [0]
    side = torch.cuda.Stream()
    # twice: a kernel's first launch in the process loads its module, which waits for
    # the card and would hide a decode that does not wait
    for _ in range(2):
        with torch.cuda.stream(side):  # the only blocks of this stream's pool are ours
            x = torch.full(idle.shape, 7, dtype=torch.uint8, device="cuda")
            ptr = x.data_ptr()
            torch.cuda._sleep(200_000_000)  # ~0.1 s of the card, queued before x's uses
            total = x.sum(dtype=torch.int64)
            x.add_(1)
            del x
            (raced,), status = nd.decode_full_batch([datas[4]], 1, device="cuda")
            side.synchronize()
        assert status == [0] and raced.data_ptr() == ptr
        assert total.item() == 7 * idle.numel()
        assert torch.equal(raced, idle)
        del raced
