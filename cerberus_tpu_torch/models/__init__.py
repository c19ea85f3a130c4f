"""Network modules: layers, ResNet backbones, NetDesc, checkpoints."""
