from .skip import SkipNet, build_skip_net
