"""Problem descriptors of the port: operand precisions and the
attention descriptor that `dispatch` resolves to a kernel callable."""
