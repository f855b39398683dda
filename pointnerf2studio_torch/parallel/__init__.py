from pointnerf2studio_torch.parallel.sharding import (
    make_mesh, make_mesh_2d, make_sharded_render, make_sharded_train_step,
    ray_slice, run_ranks)
