/* Reference-format dataset parser (C28 format; server-side read loop at
 * Dynamic-Load-Balancing/src/main.cc:49-66).
 *
 * One pass over the text buffer: read the count header, then for each
 * whitespace-separated 25-char row build the (pegs, playable) bitmask
 * pair ('1' peg, '0' hole, anything else NA — game.cc:26-38). Python
 * handles file IO and gzip and hands this the decoded bytes; parsing is
 * the hot part for the 20k-game big_set files.
 */
#include "icikit.h"

static const int kCells = 25;

static int is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

int64_t ik_parse_boards(const char* text, size_t len, uint32_t* pegs,
                        uint32_t* playable, int64_t capacity) {
  size_t i = 0;
  while (i < len && is_space(text[i])) i++;
  if (i >= len || text[i] < '0' || text[i] > '9') return -1;
  int64_t count = 0;
  while (i < len && text[i] >= '0' && text[i] <= '9') {
    count = count * 10 + (text[i] - '0');
    if (count > (int64_t)1 << 40) return -1;
    i++;
  }
  if (i < len && !is_space(text[i])) return -1;
  if (count > capacity) return -4;

  int64_t parsed = 0;
  while (parsed < count) {
    while (i < len && is_space(text[i])) i++;
    if (i >= len) return -3;
    size_t start = i;
    while (i < len && !is_space(text[i])) i++;
    if (i - start != (size_t)kCells) return -2;
    uint32_t p = 0, q = 0;
    for (int c = 0; c < kCells; ++c) {
      char ch = text[start + c];
      if (ch == '1') {
        p |= 1u << c;
        q |= 1u << c;
      } else if (ch == '0') {
        q |= 1u << c;
      } /* else NA: neither mask */
    }
    pegs[parsed] = p;
    playable[parsed] = q;
    parsed++;
  }
  return parsed;
}
