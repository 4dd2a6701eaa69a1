"""The test processes' thread budget (``testing.share_cpu_threads``).

Each pytest-xdist worker takes an equal share of the cores for torch's
intra-op pool; the package itself sets no thread count when imported.
"""

import subprocess
import sys
from pathlib import Path

import pytest

from keypoints_tpu_torch.testing import share_cpu_threads, thread_budget

share_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("cores, workers, want", [
    (8, 6, 1), (8, 1, 8), (2, 6, 1), (8, 4, 2), (64, 6, 10), (1, 1, 1)])
def test_thread_budget(cores, workers, want):
    assert thread_budget(cores, workers) == want


def test_importing_the_package_sets_no_thread_count():
    """In a fresh process with this one's environment (xdist's worker count
    included), importing the package, its CLIs and ``testing`` leaves
    torch's own default."""
    code = ("import torch; default = torch.get_num_threads(); "
            "import keypoints_tpu_torch, keypoints_tpu_torch.train, "
            "keypoints_tpu_torch.serve, keypoints_tpu_torch.testing; "
            "print(default, torch.get_num_threads())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    default, after = out.stdout.split()
    assert after == default
