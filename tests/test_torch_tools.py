"""``tools/time_kernel.py`` on the CPU: its arguments, and its check of a
build against the plain version, run with the plain version standing in
for the CUDA launcher (the builds and the timing need the card)."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import time_kernel  # noqa: E402

#: small cases of each kernel, in the arguments of its ``inputs``
SMALL = {"block_stats": {"k10": (64, 10, "gauss"), "k102": (9, 102, "gauss"),
                         "edge1024": (8, 1024, "edge")},
         "ef_stats_telemetry": {"k10": (64, 10, "gauss"),
                                "k102": (9, 102, "gauss"),
                                "edge1024": (8, 1024, "edge")},
         "ef_block_stats": {"k41": (33, 41, "gauss"),
                            "edge1": (8, 1, "edge")},
         "wkv_forward": {"ragged": (1, 9, 2, 32, 20),
                         "decode": (2, 1, 2, 32, 32)},
         "pack_words": {"k10": (3, 512, 16, 0, 0, True),
                        "v8": (2, 512, 8, 0, 0, True),
                        "ragged29": (9, 40, 4, 29, 0, True),
                        "head16": (5, 203, 16, 0, 1, True)},
         "unpack_words": {"k10": (3, 512, 16, 0, 0, False),
                          "b4": (33, 100, 4, 0, 0, False),
                          "ragged11": (97, 40, 16, 11, 0, False),
                          "head8": (5, 203, 8, 0, 1, False)}}


def test_time_kernel_arguments():
    args = time_kernel.parse_args(["block_stats", "--extra", "a.cu", "b.cu"])
    assert (args.kernel, args.extra) == ("block_stats", ["a.cu", "b.cu"])
    assert time_kernel.parse_args(["wkv_forward"]).extra == []
    for name in ("ef_stats_telemetry", "ef_block_stats", "pack_words",
                 "unpack_words"):
        assert time_kernel.parse_args([name]).kernel == name
    args = time_kernel.parse_args(["unpack_words", "--extra", "old.cu"])
    assert (args.kernel, args.extra) == ("unpack_words", ["old.cu"])
    with pytest.raises(SystemExit):
        time_kernel.parse_args(["flash_attention"])
    with pytest.raises(SystemExit):
        time_kernel.parse_args([])


def test_time_kernel_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        time_kernel.main(["block_stats"])


@pytest.mark.parametrize("name", sorted(time_kernel.KERNELS))
def test_time_kernel_check_holds_a_build_to_the_plain_version(name):
    kernel = time_kernel.KERNELS[name]
    gen = torch.Generator().manual_seed(0)
    data = {case: kernel.inputs(gen, "cpu", *args)
            for case, args in SMALL[name].items()}
    want = {case: kernel.plain(*args) for case, args in data.items()}
    line = time_kernel.check(kernel, "plain", kernel.plain, data, want)
    assert line.startswith("check plain: ") and line.count("0.00e+00") == \
        len(data)

    with pytest.raises(SystemExit, match="from the plain version"):
        time_kernel.check(kernel, "off", _off(kernel), data, want)


def _off(kernel):
    """A build whose outputs are a little off the plain version's."""
    def call(*args):
        got = kernel.plain(*args)
        return tuple(t * 1.001 for t in got) if isinstance(got, tuple) \
            else got * 1.001
    return call


@pytest.mark.parametrize("name", sorted(time_kernel.KERNELS))
def test_time_kernel_says_whether_builds_are_bit_identical(name):
    kernel = time_kernel.KERNELS[name]
    gen = torch.Generator().manual_seed(1)
    data = {case: kernel.inputs(gen, "cpu", *args)
            for case, args in SMALL[name].items()}
    assert time_kernel.identical("extra0", kernel.plain, kernel.plain,
                                 data) == \
        "bits extra0 vs this: identical at every case"
    assert time_kernel.identical("extra0", _off(kernel), kernel.plain,
                                 data) == \
        f"bits extra0 vs this: differ at {', '.join(SMALL[name])}"


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("name", ["pack_words", "unpack_words"])
def test_narrowing_casts_match_the_plain_versions(name, bits):
    """The yardstick of the wire kernels: one narrowing cast computes
    pack_words (``to(int16 | int8).view(int32)``) and unpack_words
    (``view(uint16 | uint8).to(int32)``) bit for bit, on random int32
    patterns and on the edges of the signed range."""
    from chip_smoke import cast_pack, cast_unpack
    from repro_torch.kernels import ref
    kernel = time_kernel.KERNELS[name]
    gen = torch.Generator().manual_seed(bits)
    x, _, counts, period = kernel.inputs(gen, "cpu", 6, 64, bits, 0, 0,
                                         name == "pack_words")
    x = x.clone()
    x.view(-1)[:4] = torch.tensor([-2**31, 2**31 - 1, -1, 0])
    want = kernel.plain(x, bits, counts, period)
    assert torch.equal(kernel.library(x, bits, counts, period), want)
    cast = cast_pack if name == "pack_words" else cast_unpack
    assert torch.equal(cast(x, bits), want)
    plain = ref.pack_fields if name == "pack_words" else ref.unpack_fields
    assert torch.equal(plain(x, bits), want)
