from repro_torch.envs.arm import Arm7, Reacher2, make_env
from repro_torch.envs.base import Env
from repro_torch.envs.classic import CartpoleSwingup, Pendulum, SpringHopper
