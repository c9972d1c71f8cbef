"""``launch/costs.py::cell_costs`` of the SSM and MoE configurations
against the JAX package's, as ``test_torch_costs.py`` holds the
attention-only ones (a file of its own so that the reference's compiles
spread over two test workers): the stem, head and optimizer components
within ``COST_TOL`` of the reference's, the groups' ratios printed (run
with ``-s``) and held to a factor of 2.  The reference counts a
recurrence's loop body once and adds an analytic correction
(``_ssm_scan_correction``); the port counts K6's and K7's own work
(``kernels/work.py``)."""
import pytest
import torch
from test_torch_costs import SSM_OR_MOE, check_components, mesh11  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", SSM_OR_MOE)
def test_ssm_and_moe_cell_costs_against_the_references(arch, mesh11):  # noqa: F811
    check_components(arch, mesh11)
