from pointnerf2studio_torch.models.mvsnet.mvsnet import (
    MVSNetParams, load_mvsnet_params, mvsnet_depth)
from pointnerf2studio_torch.models.mvsnet.featurenet import (
    FPNParams, load_fpn_params, fpn_features, premlp_embed)
