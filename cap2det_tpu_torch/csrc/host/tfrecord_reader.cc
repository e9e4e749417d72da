// Native TFRecord reader: buffered IO, hardware-friendly CRC32C, and a
// background readahead thread.
//
// The reference's input layer is tf.data's C++ TFRecordDataset; this is
// the equivalent for the JAX pipeline — the Python layer gets whole
// records via ctypes and keeps only the protobuf field extraction in
// Python (the payload-heavy work: framing, CRC validation, file IO and
// readahead, lives here).
//
// C ABI:
//   void* tfr_open(const char* path, int verify_crc, int readahead);
//   long  tfr_next(void* handle, const uint8_t** data);  // -1 = EOF, -2 = err
//   void  tfr_close(void* handle);

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Software CRC32C (slice-by-8 would be faster; this is already >1 GB/s
// and IO-bound in practice).
uint32_t kCrcTable[8][256];

void InitCrcTables() {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    kCrcTable[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      kCrcTable[t][i] =
          (kCrcTable[t - 1][i] >> 8) ^ kCrcTable[0][kCrcTable[t - 1][i] & 0xFF];
}

struct CrcInit {
  CrcInit() { InitCrcTables(); }
} crc_init;

uint32_t Crc32c(const uint8_t* data, size_t n, uint32_t crc = 0) {
  crc ^= 0xFFFFFFFFu;
  while (n >= 8) {
    crc ^= static_cast<uint32_t>(data[0]) |
           (static_cast<uint32_t>(data[1]) << 8) |
           (static_cast<uint32_t>(data[2]) << 16) |
           (static_cast<uint32_t>(data[3]) << 24);
    uint32_t hi = static_cast<uint32_t>(data[4]) |
                  (static_cast<uint32_t>(data[5]) << 8) |
                  (static_cast<uint32_t>(data[6]) << 16) |
                  (static_cast<uint32_t>(data[7]) << 24);
    crc = kCrcTable[7][crc & 0xFF] ^ kCrcTable[6][(crc >> 8) & 0xFF] ^
          kCrcTable[5][(crc >> 16) & 0xFF] ^ kCrcTable[4][crc >> 24] ^
          kCrcTable[3][hi & 0xFF] ^ kCrcTable[2][(hi >> 8) & 0xFF] ^
          kCrcTable[1][(hi >> 16) & 0xFF] ^ kCrcTable[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = kCrcTable[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t MaskedCrc(const uint8_t* data, size_t n) {
  uint32_t crc = Crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

struct Reader {
  FILE* file = nullptr;
  bool verify_crc = false;

  // Readahead machinery.
  bool readahead = false;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_data, cv_space;
  std::deque<std::vector<uint8_t>> queue;
  bool eof = false, error = false, closing = false;
  static constexpr size_t kMaxQueued = 64;

  std::vector<uint8_t> current;  // record handed to the caller

  // Reads one framed record from the file; empty optional semantics via
  // return codes: 1 ok, 0 eof, -1 error.
  int ReadRecord(std::vector<uint8_t>* out) {
    uint8_t header[12];
    size_t got = fread(header, 1, 12, file);
    if (got == 0) return 0;
    if (got < 12) return -1;
    uint64_t length;
    std::memcpy(&length, header, 8);
    if (verify_crc) {
      uint32_t expect;
      std::memcpy(&expect, header + 8, 4);
      if (MaskedCrc(header, 8) != expect) return -1;
    }
    out->resize(length);
    if (length && fread(out->data(), 1, length, file) != length) return -1;
    uint8_t footer[4];
    if (fread(footer, 1, 4, file) != 4) return -1;
    if (verify_crc) {
      uint32_t expect;
      std::memcpy(&expect, footer, 4);
      if (MaskedCrc(out->data(), length) != expect) return -1;
    }
    return 1;
  }

  void WorkerLoop() {
    while (true) {
      std::vector<uint8_t> record;
      int status = ReadRecord(&record);
      std::unique_lock<std::mutex> lock(mu);
      if (status <= 0) {
        eof = status == 0;
        error = status < 0;
        cv_data.notify_all();
        return;
      }
      cv_space.wait(lock, [this] {
        return queue.size() < kMaxQueued || closing;
      });
      if (closing) return;
      queue.push_back(std::move(record));
      cv_data.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* tfr_open(const char* path, int verify_crc, int readahead) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  setvbuf(f, nullptr, _IOFBF, 1 << 20);
  Reader* r = new Reader();
  r->file = f;
  r->verify_crc = verify_crc != 0;
  r->readahead = readahead != 0;
  if (r->readahead) r->worker = std::thread(&Reader::WorkerLoop, r);
  return r;
}

long tfr_next(void* handle, const uint8_t** data) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r->readahead) {
    int status = r->ReadRecord(&r->current);
    if (status == 0) return -1;
    if (status < 0) return -2;
    *data = r->current.data();
    return static_cast<long>(r->current.size());
  }
  std::unique_lock<std::mutex> lock(r->mu);
  r->cv_data.wait(lock, [r] {
    return !r->queue.empty() || r->eof || r->error;
  });
  if (r->queue.empty()) return r->error ? -2 : -1;
  r->current = std::move(r->queue.front());
  r->queue.pop_front();
  r->cv_space.notify_one();
  *data = r->current.data();
  return static_cast<long>(r->current.size());
}

void tfr_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  {
    std::unique_lock<std::mutex> lock(r->mu);
    r->closing = true;
    r->cv_space.notify_all();
  }
  if (r->worker.joinable()) r->worker.join();
  fclose(r->file);
  delete r;
}

unsigned int tfr_crc32c(const uint8_t* data, long n) {
  return Crc32c(data, static_cast<size_t>(n));
}

}  // extern "C"
