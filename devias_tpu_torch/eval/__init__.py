"""Evaluation protocols and result merging of the port."""

from devias_tpu_torch.eval.merge import merge_results, parse_result_file, softmax_np, write_result_file
from devias_tpu_torch.eval.protocols import (
    count_hat_acc,
    final_test,
    hat_eval,
    run_scuba,
    validation_one_epoch,
)

__all__ = [
    "count_hat_acc", "final_test", "hat_eval", "merge_results", "parse_result_file",
    "run_scuba", "softmax_np", "validation_one_epoch", "write_result_file",
]
