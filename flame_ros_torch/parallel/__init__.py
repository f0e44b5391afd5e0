"""Batched and multi-device execution: many streams over device lists
(multi_stream), the spatial NLTGV2 partition (spatial_pd) and the
multi-process worker (dist_e2e)."""
