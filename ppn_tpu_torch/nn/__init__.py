from ppn_tpu_torch.nn.model import PoseProposalNet, PPNHead, num_params

__all__ = ["PPNHead", "PoseProposalNet", "num_params"]
