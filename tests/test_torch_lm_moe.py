"""The port's MoE family against the JAX package's on the CPU:
qwen3-moe-30b-a3b (128 experts top-8 at full width) and
llama4-scout-17b-a16e (top-1 and a shared expert, chunked-local and NoPE
global attention), at their smoke configs.  The cases and their
tolerances are tests/_lm_families.py's; this file runs them for these two
archs, with the cases that are not per arch split between it and
tests/test_torch_lm_ssm.py."""
import pytest
from _lm_families import (  # noqa: F401 -- collected here
    test_full_width_init_matches_reference,
    test_generate_matches_reference,
    test_init_matches_reference_shapes,
    test_interop_carries_the_new_leaves,
    test_lm_builds_full_and_smoke,
    test_model_matches_reference,
    test_serve_lm_example_matches_reference,
    test_train_step_matches_reference,
    test_unknown_mixer_raises,
)


@pytest.fixture(params=["qwen3_moe_30b_a3b", "llama4_scout_17b_a16e"])
def arch(request):
    return request.param
