"""The H100 roofline of a step: its constants and terms (`analysis`) and the
cost of every aten op a traced step dispatches (`op_cost`)."""
