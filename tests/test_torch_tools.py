"""The kernel-variant timing tool (tools/kernel_variants.py) on the CPU:
every named variant's source edits still apply to the package's kernels
(``mu_h.cu``, and the other sources a variant names).
Its timing runs need a CUDA card."""

import importlib

import pytest

kv = importlib.import_module('tools.kernel_variants')


@pytest.mark.parametrize('name', sorted(kv.VARIANTS))
def test_variant_edits_apply(name, tmp_path, monkeypatch):
    monkeypatch.setattr(kv, 'WORK', tmp_path)
    dst = kv.make_copy(name)
    edits = kv.variant_edits(name)
    for source in {'mu_h.cu', *(e[0] for e in edits)}:
        src = (kv.ROOT / 'tnmf_tpu_torch' / 'csrc' / source).read_text()
        got = (dst / 'tnmf_tpu_torch' / 'csrc' / source).read_text()
        news = [n for s, _, n in edits if s == source]
        assert (got != src) == bool(news)
        for new in news:
            assert new in got
    # the copy holds the whole package and no build
    assert (dst / 'tnmf_tpu_torch' / 'kernels' / 'mu_h.py').is_file()
    assert not (dst / 'tnmf_tpu_torch' / '_build').exists()


ks = importlib.import_module('tools.k4_streamed_tiles')


@pytest.mark.parametrize('dims,ranges', ks.CASES)
def test_k4_sweep_cases_stream(dims, ranges):
    """Every case of the K4 tile sweep takes the streamed route, same-atom
    and with the cross-atom term, and has streamed tiles to compare."""
    from tnmf_tpu_torch.kernels import _build, inhibit
    taps = tuple(2 * r + 1 for r in ranges)
    for cross in (False, True):
        assert inhibit.launch_geometry(dims, taps, cross)['n_segments'] > 1
        tx, ty = taps if len(taps) == 2 else (1,) + taps
        X, Y = dims[2:] if len(taps) == 2 else (1, dims[2])
        tiles = inhibit._tiles(tx, ty, len(taps) == 2, X, Y)
        assert any(inhibit._streamed(a, b, tx, ty, len(taps) == 2, cross,
                                     _build.MAX_SMEM_BYTES) for a, b in tiles)
