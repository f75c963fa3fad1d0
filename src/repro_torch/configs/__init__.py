"""The paper's experiment configurations."""
