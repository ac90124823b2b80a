"""Evaluation: the lm_eval-style harness, its tasks and the LM adapters,
and the long-context evaluation."""
