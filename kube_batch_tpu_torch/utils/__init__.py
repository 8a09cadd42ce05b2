from .priority_queue import PriorityQueue
from .scheduler_helper import (predicate_nodes, prioritize_nodes,
                               select_best_node, sort_nodes, get_node_list)

__all__ = ["PriorityQueue", "predicate_nodes", "prioritize_nodes",
           "select_best_node", "sort_nodes", "get_node_list"]
