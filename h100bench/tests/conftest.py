import pytest
import torch


@pytest.fixture
def cuda():
    """The card, TF32 off; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)
