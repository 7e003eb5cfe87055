from .graph import ConstantNode, Graph, Node, OperatorNode, ValueNode

__all__ = ["Graph", "Node", "OperatorNode", "ConstantNode", "ValueNode"]
