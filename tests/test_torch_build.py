"""The CUDA build's bookkeeping and the kernel wrappers' host constants,
checked on the CPU (no card or nvcc needed).

A library is rebuilt only when the hash over its source, `_build.HEADERS`
and the flags changes, so every header a source includes must be in
`HEADERS` and every source in `SOURCES`; otherwise an edited header would
leave a stale library in use. The wrappers pass f32(1/√N) to the kernels
from a cache rounded through numpy; it must carry the bits of the f32
tensor that `ref.fwht` multiplies by."""
import math
import re

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import inv_sqrt


def _csrc_files(pattern):
    return sorted(_build.CSRC.glob(pattern))


def test_every_included_header_is_hashed():
    included = set()
    for path in _csrc_files("*.cu") + _csrc_files("*.cuh"):
        included |= set(re.findall(r'#include\s+"([^"]+)"', path.read_text()))
    assert included, "no local includes found"
    assert included <= set(_build.HEADERS), (
        f"headers missing from _build.HEADERS: "
        f"{sorted(included - set(_build.HEADERS))}")
    for name in _build.HEADERS:
        assert (_build.CSRC / name).exists(), name


def test_every_source_is_built():
    sources = {p.stem for p in _csrc_files("*.cu")}
    assert sources == set(_build.SOURCES)
    assert set(_build.SOURCES) == set(_build._SIGNATURES)


@pytest.mark.parametrize("n", [2 ** i for i in range(5, 14)])
def test_cached_inv_sqrt_has_the_f32_bits(n):
    want = float(torch.tensor(1 / math.sqrt(n), dtype=torch.float32))
    got = inv_sqrt(n)
    assert isinstance(got, float)
    assert (torch.tensor(got, dtype=torch.float32).view(torch.int32)
            == torch.tensor(want, dtype=torch.float32).view(torch.int32))
    assert got == want
