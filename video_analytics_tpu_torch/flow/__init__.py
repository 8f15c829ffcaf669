# The reference's flow/__init__ binds the functions ``farneback`` and
# ``tvl1`` to its submodules' names, shadowing them.  Here the names stay
# the submodules (``flow.tvl1.tvl1`` is the function): the port's code and
# tests import them as modules.
from video_analytics_tpu_torch.flow import farneback, tvl1  # noqa: F401
