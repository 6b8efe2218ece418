from gaussian_splatting_torch.viewer.network_gui import ViewerServer

__all__ = ["ViewerServer"]
