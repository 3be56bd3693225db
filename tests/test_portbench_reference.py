"""The benchmark's check in tier-1: the cases of
portbench/tests/test_reference_buckets.py (the bucketed reference that
decides ``correct`` against the whole-table one, its control, the
generators' shapes and hashes and the yardstick's answer width), collected
here as they stand there."""
from portbench.tests.test_reference_buckets import (  # noqa: F401
    test_buckets_equal_whole_table,
    test_control_buckets_equal_whole_table,
    test_control_class_across_buckets,
    test_pangenome_deterministic_and_seeded,
    test_pangenome_layout,
    test_strain_shape_unchanged,
    test_window_keys_equal_whole_table_keys,
    test_yardstick_counts_the_answers_width,
)
