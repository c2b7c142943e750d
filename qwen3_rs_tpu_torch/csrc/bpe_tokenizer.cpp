// Native BPE encoder — host-side C++ counterpart of the reference's Rust
// tokenizer encode path (qwen3-inference/src/tokenizer.rs:165-237), with the
// O(vocab) linear scans replaced by hash lookups.  Exact same semantics as
// the Python fallback (qwen3_rs_tpu_torch/inference/tokenizer.py::_encode_py):
//
//  1. walk unicode codepoints; on '<', scan for '>' within max_token_length
//     codepoints and emit the special token if the exact substring is in the
//     vocab; otherwise emit the single-codepoint token (unknown codepoints
//     are skipped);
//  2. greedy merge loop: repeatedly merge the adjacent pair whose
//     concatenation is a vocab token with the strictly highest merge score
//     (ties keep the earliest-found pair).
//
// Exposed as a C ABI consumed via ctypes (qwen3_rs_tpu_torch/utils/native.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Bpe {
  std::vector<std::string> vocab;
  std::vector<float> scores;
  std::unordered_map<std::string_view, uint32_t> index;  // first id wins
  uint32_t max_token_length;
};

// Byte length of the UTF-8 sequence starting at s[i].
inline size_t utf8_len(unsigned char c) {
  if (c < 0x80) return 1;
  if ((c >> 5) == 0x6) return 2;
  if ((c >> 4) == 0xE) return 3;
  if ((c >> 3) == 0x1E) return 4;
  return 1;  // invalid byte: treat as one unit
}

}  // namespace

extern "C" {

void* bpe_new(const char** tokens, const uint32_t* lens, const float* scores,
              uint32_t n, uint32_t max_token_length) {
  auto* bpe = new (std::nothrow) Bpe();
  if (!bpe) return nullptr;
  bpe->vocab.reserve(n);
  bpe->scores.assign(scores, scores + n);
  bpe->max_token_length = max_token_length;
  for (uint32_t i = 0; i < n; ++i) {
    bpe->vocab.emplace_back(tokens[i] ? tokens[i] : "", lens[i]);
  }
  bpe->index.reserve(n * 2);
  for (uint32_t i = 0; i < n; ++i) {
    bpe->index.emplace(std::string_view(bpe->vocab[i]), i);  // keeps first
  }
  return bpe;
}

void bpe_free(void* handle) { delete static_cast<Bpe*>(handle); }

int32_t bpe_encode(void* handle, const char* text, uint32_t text_len,
                   uint32_t* out, uint32_t out_cap) {
  const auto* bpe = static_cast<const Bpe*>(handle);
  if (!bpe || (!text && text_len)) return -1;

  // Split into codepoint byte-ranges.
  std::vector<std::pair<uint32_t, uint32_t>> chars;  // (offset, len)
  chars.reserve(text_len);
  for (uint32_t i = 0; i < text_len;) {
    uint32_t len = static_cast<uint32_t>(utf8_len(static_cast<unsigned char>(text[i])));
    if (i + len > text_len) len = 1;
    chars.emplace_back(i, len);
    i += len;
  }

  std::vector<uint32_t> tokens;
  tokens.reserve(chars.size());
  const size_t n_chars = chars.size();
  for (size_t i = 0; i < n_chars;) {
    bool found_special = false;
    if (chars[i].second == 1 && text[chars[i].first] == '<') {
      size_t limit = n_chars;
      if (bpe->max_token_length < n_chars - i) limit = i + bpe->max_token_length;
      for (size_t j = i + 1; j < limit; ++j) {
        if (chars[j].second == 1 && text[chars[j].first] == '>') {
          std::string_view special(text + chars[i].first,
                                   chars[j].first + chars[j].second - chars[i].first);
          auto it = bpe->index.find(special);
          if (it != bpe->index.end()) {
            tokens.push_back(it->second);
            i = j + 1;
            found_special = true;
          }
          break;  // only the first '>' is considered (tokenizer.rs:177-181)
        }
      }
    }
    if (!found_special) {
      std::string_view ch(text + chars[i].first, chars[i].second);
      auto it = bpe->index.find(ch);
      if (it != bpe->index.end()) tokens.push_back(it->second);
      // unknown codepoints are skipped (tokenizer.rs:199-201)
      ++i;
    }
  }

  // Greedy highest-score merge loop (tokenizer.rs:208-234).
  std::string merged;
  while (tokens.size() > 1) {
    float best_score = -1e10f;
    int64_t best_id = -1, best_idx = -1;
    for (size_t k = 0; k + 1 < tokens.size(); ++k) {
      const std::string& a = bpe->vocab[tokens[k]];
      const std::string& b = bpe->vocab[tokens[k + 1]];
      merged.assign(a);
      merged.append(b);
      auto it = bpe->index.find(std::string_view(merged));
      if (it != bpe->index.end() && bpe->scores[it->second] > best_score) {
        best_score = bpe->scores[it->second];
        best_id = it->second;
        best_idx = static_cast<int64_t>(k);
      }
    }
    if (best_id < 0) break;
    tokens[best_idx] = static_cast<uint32_t>(best_id);
    tokens.erase(tokens.begin() + best_idx + 1);
  }

  if (tokens.size() > out_cap) return -2;
  std::memcpy(out, tokens.data(), tokens.size() * sizeof(uint32_t));
  return static_cast<int32_t>(tokens.size());
}

}  // extern "C"
