"""chip_smoke.py's phase 3d (a small f32 TinyMoeLM trained on the card
and on the CPU from the same weights and batches), driven on the CPU on
both sides. It sits apart from the MoE main-path tests
(tests/test_torch_chip_smoke_moe.py) so that neither file runs much past
five minutes on one test worker.
"""
import chip_smoke
from test_torch_chip_smoke_serving import _one_intra_op_thread  # noqa: F401


def test_moe_train_reference_phase_on_cpu():
    chip_smoke.phase_moe_train_reference(device="cpu")
