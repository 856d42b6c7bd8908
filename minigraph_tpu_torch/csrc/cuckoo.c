/* The cuckoo walk of the hash join's table (ops/anchors.py
 * HashJoinIndex.key_arrays), host C built into the port's libmgt.so.
 *
 * Key j goes in at slot s1[j]; an occupied slot hands its key on, and
 * that key moves to whichever of its two slots it was not in; after
 * max_steps moves without a free slot the walk gives up.  Keys go in
 * in index order, so the table is the one ops/anchors_hash.py builds,
 * slot for slot. */
#include <stdint.h>

/* Fills table[0..n_slots) with the key index of each slot (-1 where
 * empty).  Returns -1 when every key found a slot, else the index of
 * the key whose walk gave up (the table is then incomplete). */
int64_t mgt_cuckoo_walk(const uint32_t *s1, const uint32_t *s2,
                        int64_t n_keys, int32_t *table, int64_t n_slots,
                        int32_t max_steps)
{
	int64_t i, j;
	for (i = 0; i < n_slots; ++i) table[i] = -1;
	for (j = 0; j < n_keys; ++j) {
		int32_t cur = (int32_t)j;
		uint32_t slot = s1[j];
		int32_t step;
		for (step = 0; step < max_steps; ++step) {
			int32_t had = table[slot];
			table[slot] = cur;
			if (had < 0) break;
			cur = had;
			slot = slot == s1[cur] ? s2[cur] : s1[cur];
		}
		if (step == max_steps) return j;
	}
	return -1;
}
