"""torch.nn modules of the port: backbone, FPN, fusion, RPN, heads,
detector."""
