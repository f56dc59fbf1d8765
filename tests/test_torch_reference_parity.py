"""fasterseg_tpu_torch DerivedNet against the reference implementation.

tests/assets/parity_{student,teacher}.npz hold a seeded-random-weight
reference `Network_Multi_Path_Infer` state_dict (`state/*`, with
`num_batches_tracked` and the aux heads) and its eval-mode forward output on
a fixed NHWC input. The port's module names are the reference's, so the
state_dict loads as it is; the bar is the JAX package's
(tests/test_torch_parity.py).
"""

import os

import numpy as np
import pytest
import torch

from fasterseg_tpu_torch.models import DerivedNet, student_plan, teacher_plan
from fasterseg_tpu_torch.utils import load_reference_state_dict


@pytest.mark.parametrize("name,planner", [
    ("student", student_plan),
    ("teacher", teacher_plan),
])
def test_forward_matches_reference(assets_dir, name, planner):
    data = np.load(os.path.join(assets_dir, f"parity_{name}.npz"))
    sd = {k[len("state/"):]: data[k] for k in data.files
          if k.startswith("state/")}
    net = DerivedNet(planner())
    load_reference_state_dict(net, sd)
    # every tensor the port's net holds came from the reference state_dict
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    with torch.no_grad():
        out = net(torch.from_numpy(data["input"])).numpy()
    assert out.shape == data["output"].shape
    np.testing.assert_allclose(out, data["output"], rtol=2e-4, atol=2e-4)
