"""The port's query engine (`query/sql.py`, `engine.py`), the volume
Query route and S3 SelectObjectContent held against the JAX package's.

Every case of tests/test_query.py runs in both packages through `_torch_twin`:
the same seeded inputs, the reference's own asserts in each, and the
values those asserts compare must be equal across the two (masked
fields: see `_torch_twin`).  `test_s3_select_csv` writes into the
bucket `test_s3_select_object_content` made on the reference's
module-scoped stack, so here it runs after that case on the same stack.
"""

from __future__ import annotations

import pytest

from _torch_cluster import hermetic_port_state  # noqa: F401
from _torch_twin import TwinFile

pytestmark = pytest.mark.torch

TWIN = TwinFile("test_query.py", prelude={
    "test_s3_select_csv": ("test_s3_select_object_content",)})


@pytest.mark.parametrize("case", TWIN.ids())
def test_query_case_in_both_packages(case, tmp_path):
    TWIN.run(case, tmp_path)
