"""Row-tile data parallelism over ``torch.distributed`` (port of
``bpt_tpu.parallel``): each rank traces the contiguous rows JAX's mesh would
give its device; see ``bpt_tpu_torch.parallel.sharding``."""

from bpt_tpu_torch.parallel.sharding import (make_mesh, replicate, sharded_render_frame, sharded_screen_output,
                                             sharded_trace, sum_over_tiles, tile_rows)
