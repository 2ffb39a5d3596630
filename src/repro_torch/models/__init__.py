"""The model families: the LM (layers, the dense and MoE decoder-only
transformer), RecSys (DeepFM, DCN-v2, DIEN, MIND) and GNN (GatedGCN),
the one dispatch point over them (``api.get_api``), and the weight
bridge from the JAX package's parameter pytrees."""
