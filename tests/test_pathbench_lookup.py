"""The benchmark's reference lookup, run with the repository's tests: the
tests of ``pathbench/tests`` that the ``sponza-720p-ext`` cell depends on,
collected here as they are written there.

* a reference added as a file is found by the name a cell gives, handed
  the cell and the scene file, and judges the run's frames;
* a cell whose traffic names an extension its reference does not compute
  is refused before set-up, by ``spec.load_workload``, the harness and
  the command; a missing or malformed reference is named;
* the cells that name no reference take ``plain``, whose entry point
  renders as the reference object before it did, in float32 and
  bfloat16.
"""

from pathbench.tests.conftest import tiny_contest  # noqa: F401  (a fixture)
from pathbench.tests.test_pathbench_reference import (  # noqa: F401
    few_threads,
    test_the_plain_entry_point_renders_as_before,
)
from pathbench.tests.test_pathbench_references import (  # noqa: F401
    copy_root,
    test_a_missing_or_malformed_reference_is_named,
    test_a_reference_added_by_name_is_found_and_used,
    test_an_extension_the_reference_lacks_is_refused,
    test_the_cells_take_the_plain_reference,
)
