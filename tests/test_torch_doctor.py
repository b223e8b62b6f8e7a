"""``tests/test_doctor.py`` on the port (``port_namespace`` of
``test_torch_cluster.py``): the fleet doctor's invariant sweeps (a clean
fleet at zero findings, the observer path, a dead primary within one
sweep, raise and clear, offset and epoch regressions, the findings
counter), the black-box canary, the CLUSTER DOCTOR surface armed and
unarmed, INFO doctor, CLUSTER MIGRATIONS, the ``rtpu_doctor_*``
families and the routing client's ``doctor_status``; the kill -9 and
clean chaos soaks keep the reference's ``slow`` mark and run their
subprocess fleets with ``--device cpu``.

Nothing is left out: every test of the reference module runs here.
"""

import pytest

torch = pytest.importorskip("torch")

import test_doctor as _ref  # noqa: E402
from test_torch_cluster import cpu_builtins, port_namespace  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401

globals().update(port_namespace(_ref, cpu_builtins))
