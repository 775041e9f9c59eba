from repro_torch.configs.base import ArchConfig, MoEConfig, MambaConfig, XLSTMConfig, get_config, ARCH_IDS  # noqa: F401
