"""Language models of the port: the serving path of Granite-3-8B and Mamba2-2.7B."""
