from repro_torch.checkpoint.checkpoint import (FEDERATION_SCHEMA,
                                               available_steps, from_indexed,
                                               indexed, latest_step, load,
                                               restore, save,
                                               save_federation)

__all__ = ["FEDERATION_SCHEMA", "available_steps", "from_indexed",
           "indexed", "latest_step", "load", "restore", "save",
           "save_federation"]
