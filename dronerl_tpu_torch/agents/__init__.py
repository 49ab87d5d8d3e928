"""The DQN agent (dense Q-networks)."""
