"""The kernel-variant timing tool (tools/kernel_variants.py) on the CPU:
every named variant's source edits still apply to the package's kernels.
Its timing runs need a CUDA card."""

import importlib

import pytest

kv = importlib.import_module('tools.kernel_variants')


@pytest.mark.parametrize('name', sorted(kv.VARIANTS))
def test_variant_edits_apply(name, tmp_path, monkeypatch):
    monkeypatch.setattr(kv, 'WORK', tmp_path)
    dst = kv.make_copy(name)
    src = (kv.ROOT / 'tnmf_tpu_torch' / 'csrc' / 'mu_h.cu').read_text()
    got = (dst / 'tnmf_tpu_torch' / 'csrc' / 'mu_h.cu').read_text()
    assert (got != src) == bool(kv.VARIANTS[name])
    for new in (n for _, n in kv.VARIANTS[name]):
        assert new in got
    # the copy holds the whole package and no build
    assert (dst / 'tnmf_tpu_torch' / 'kernels' / 'mu_h.py').is_file()
    assert not (dst / 'tnmf_tpu_torch' / '_build').exists()
