"""Shared constants (reference include/optimized_impl.h:26-28, README.md:27).

The PyTorch port's own copy of ``hvq_tpu.constants``.
"""

K_DEFAULT = 100          # contest k
VEC_DIM = 100            # vector dimensionality
DATA_RECORD_DIM = 102    # C, T + 100 dims per data record
QUERY_RECORD_DIM = 104   # type, v, l, r + 100 dims per query record

# Padded vector width used on device: vectors are zero-padded from 100 to
# 128, eight 16-deep k-steps of the tensor-core product.
PADDED_DIM = 128

# The reference's distance-comparison tolerance (src/compare_data.cpp:5),
# justified by its SIMD-vs-scalar summation-order study
# (src/fp_inaccuracy_test.cpp:77-98, report.docx "Floating-Point Inaccuracy").
DIST_TOLERANCE = 0.002
