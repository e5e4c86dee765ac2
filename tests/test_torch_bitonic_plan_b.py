"""The schedule of the port's bitonic kernel on CPU, the sizes that
``test_torch_bitonic_plan.py`` leaves to this file (the two files run on
two workers under ``--dist loadfile``): the same two checks, the plan's
coverage of the network and its plain executor against
``bitonic_sort_plain`` and the JAX Pallas sort in interpret mode."""
import pytest

import test_torch_bitonic_plan as plan
from test_torch_bitonic_plan import one_thread  # noqa: F401  (autouse)

LOG_NS = (15, 14, 11, 9, 8, 7, 6, 4, 2, 1)
assert sorted(LOG_NS + plan.LOG_NS) == list(range(1, 17))


@pytest.mark.parametrize("log_tile", plan.LOG_TILES)
@pytest.mark.parametrize("log_n", LOG_NS)
def test_pass_plan_covers_the_network_once_in_order(log_n, log_tile):
    plan.test_pass_plan_covers_the_network_once_in_order(log_n, log_tile)


@pytest.mark.parametrize("log_tile", plan.LOG_TILES)
@pytest.mark.parametrize("log_n", LOG_NS)
def test_pass_plan_executor_matches_plain_and_jax(log_n, log_tile):
    plan.test_pass_plan_executor_matches_plain_and_jax(log_n, log_tile)
