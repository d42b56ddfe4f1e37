"""The plain reference: the configurations' objective and L-BFGS in
plain PyTorch, from the generated inputs alone."""
