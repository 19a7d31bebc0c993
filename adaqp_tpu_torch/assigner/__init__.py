from .assignment import Assignment, random_assignment, uniform_assignment  # noqa: F401
from .assigner import Assigner, AssignerConfig  # noqa: F401
