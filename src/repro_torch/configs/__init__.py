from repro_torch.configs.paper_mnist import PAPER, PaperConfig

__all__ = ["PAPER", "PaperConfig"]
