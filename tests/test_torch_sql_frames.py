"""The JAX package's SQL tests in tests/test_sql_window_frames.py,
test_window_device_keys.py and test_sql_nulls_having.py, run through the
port too (tests/torch_sql_diff.py): every statement they run goes
through csv_simd_tpu's sql and csv_simd_tpu_torch.sql(device="cpu") on
both engines, with the device thresholds as each test sets them and
forced to 1. Window float sums are bit for bit; float32 group and
statistics sums in a SqlResult within rtol 1e-5; everything else exact."""

import pytest
import torch

import test_sql_nulls_having
import test_sql_window_frames
import test_window_device_keys
import torch_sql_diff


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("module,name,params", torch_sql_diff.cases(
    test_sql_window_frames, test_window_device_keys, test_sql_nulls_having))
def test_jax_sql_test_agrees(module, name, params, monkeypatch, tmp_path,
                             capsys):
    torch_sql_diff.run_case(module, name, params, monkeypatch, tmp_path,
                            capsys)
