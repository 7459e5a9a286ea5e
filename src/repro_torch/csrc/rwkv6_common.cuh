// Shared by rwkv6.cu and rwkv6_bwd.cu.
#pragma once

// Steps between the forward's checkpoints of the float32 state: the
// forward stores the state before every kCkptSteps-th step when it is
// given a checkpoint buffer, and the backward recomputes one such interval
// at a time from its checkpoint (rwkv6.cu explains the choice).
constexpr int kCkptSteps = 16;
