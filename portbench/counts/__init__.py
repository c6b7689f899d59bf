"""Work counts from call shapes: bytes and FLOP that an operation needs,
whatever implements it, and the least time they take at the card's peaks."""
