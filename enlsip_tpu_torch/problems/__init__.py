from .hs import HS_PROBLEMS, get_problem, problem_names

__all__ = ["HS_PROBLEMS", "get_problem", "problem_names"]
